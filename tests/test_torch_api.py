"""The port's API surface against the JAX package's on the CPU.

``Optimizer.optimize`` and every MOI-style accessor, ``solve_sdp``,
``solve_cone_program`` (ingest) and ``solve_cvxpy_problem`` (against
tests/_fake_cvxpy.py: cvxpy is not installed), the MIMO and sensor
localisation models and the SDPA reader, each solved through both
packages on the same input under the default options at
``chunk_iters=256`` (the port's fixed chunk) and
``block_equilibration_probe_iters=200`` (where rows spread, as sensor
localisation's do, the probe's arms then stop at that depth and not at a
20 s clock that the two packages reach after different depths: ROADMAP
C16): the same status and termination string, the iteration count within
25 % and the objective within 2e-4 (1 + |obj|) -- the hybrid f32 race sums
in other orders in the two packages.  The port solves with
``device="cpu"``, its plain PyTorch path.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx

CHUNK = dict(chunk_iters=256, block_equilibration_probe_iters=200)


def _agree(rt, rj, obj_rtol=2e-4):
    assert rt.status == rj.status
    assert rt.termination_status == rj.termination_status
    assert rt.status_string == rj.status_string
    assert abs(rt.iter - rj.iter) <= 0.25 * rj.iter, (rt.iter, rj.iter)
    assert abs(rt.objval - rj.objval) <= obj_rtol * (1 + abs(rj.objval)), (
        rt.objval, rj.objval)


def _model(pkg):
    """min tr(X) + 2 x  s.t.  X_00 = 1, X_11 >= 0.5 (as -X_11 <= -0.5),
    x >= 0.25 (as -x <= -0.25): one eq row, two ineq rows, a PSD block and
    a free variable."""
    opt = pkg.Optimizer(**CHUNK)
    X = opt.add_psd_var(2)
    (x,) = opt.add_free_vars(1)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.add_ineq_constraint({int(X[1, 1]): -1.0}, -0.5)
    opt.add_ineq_constraint({int(x): -1.0}, -0.25)
    coeffs = opt.psd_inner_product_coeffs(X, np.eye(2))
    coeffs[int(x)] = 2.0
    opt.set_objective(coeffs, sense="min", constant=0.5)
    return opt, X


def test_optimize_and_accessors_match_jax():
    """optimize() on the card by default, here device="cpu"; every
    accessor against the JAX package's: statuses and strings equal,
    values to the solve's tolerance (duals and slacks 1e-3)."""
    (oj, Xj), (ot, Xt) = _model(jx), _model(tx)
    assert ot.result is None and ot.result_count == 0
    assert ot.primal_status == ot.dual_status == "NO_SOLUTION"
    with pytest.raises(RuntimeError, match="optimize"):
        ot.objective_value
    rj = oj.optimize()
    rt = ot.optimize(device="cpu")
    assert rt is ot.result
    _agree(rt, rj)
    assert abs(rt.objval - 2.5) < 1e-3  # tr X 1.5, 2 x 0.5, constant 0.5
    for name in ("termination_status", "raw_status_string", "result_count",
                 "primal_status", "dual_status", "silent", "time_limit_sec"):
        assert getattr(ot, name) == getattr(oj, name), name
    for name in ("objective_value", "dual_objective_value"):
        assert abs(getattr(ot, name) - getattr(oj, name)) <= 2e-4 * (
            1 + abs(getattr(oj, name))), name
    assert ot.pdhg_iterations == rt.iter and ot.solve_time_sec > 0
    np.testing.assert_allclose(ot.get_psd_solution(Xt),
                               oj.get_psd_solution(Xj), atol=1e-3)
    for get, rows in (("get_eq_dual", 1), ("get_eq_slack", 1),
                      ("get_ineq_dual", 2), ("get_ineq_slack", 2)):
        for r in range(rows):
            assert abs(getattr(ot, get)(r) - getattr(oj, get)(r)) < 1e-3, get


def test_optimize_options_and_setters():
    """Keyword options of optimize() are Options fields for that solve;
    ``device`` is not one; silent and time_limit_sec set the options as
    the JAX package's setters do."""
    ot, _ = _model(tx)
    r = ot.optimize(device="cpu", max_iter=3)
    assert r.status == 3 and r.iter == 3
    assert ot.options.max_iter != 3
    with pytest.raises(TypeError, match="device"):
        tx.Optimizer(device="cpu")
    oj, _ = _model(jx)
    for o in (ot, oj):
        o.silent = False
        o.time_limit_sec = 12.5
    assert (ot.options.log_verbose, ot.options.time_limit, ot.time_limit_sec) \
        == (oj.options.log_verbose, oj.options.time_limit, oj.time_limit_sec)
    for o in (ot, oj):
        o.time_limit_sec = None
    assert ot.options.time_limit == oj.options.time_limit == 360000.0
    assert ot.time_limit_sec is None


def test_entry_points_default_to_the_card(monkeypatch):
    """optimize, solve_sdp, solve_cone_program and solve_cvxpy_problem run
    on the card unless told otherwise: with no card they raise, naming the
    CPU path, and never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ot, _ = _model(tx)
    for call in (ot.optimize,
                 lambda: tx.solve_sdp(np.eye(2), As=[np.eye(2)], bs=[1.0]),
                 lambda: tx.solve_cone_program(np.ones(1), -np.ones((1, 1)),
                                               -np.ones(1), dims={"l": 1})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_solve_sdp_matches_jax():
    """solve_sdp: the min-eigenvalue SDP and a max-sense SDP with an
    inequality row (tests/test_conformance.py's shapes), X and the result
    against the JAX package's."""
    C = np.array([[2.0, 1.0], [1.0, 2.0]])
    cases = [dict(C=C, As=[np.eye(2)], bs=[1.0]),
             dict(C=-C, As=[np.eye(2)], bs=[1.0], Gs=[np.diag([1.0, 0.0])],
                  hs=[0.3], sense="max")]
    for kw in cases:
        Xj, rj = jx.solve_sdp(**kw, **CHUNK)
        Xt, rt = tx.solve_sdp(**kw, **CHUNK, device="cpu")
        _agree(rt, rj)
        np.testing.assert_allclose(Xt, Xj, atol=1e-3)


def test_solve_cone_program_matches_jax():
    """solve_cone_program on an SCS-form program with every cone kind (the
    conformance battery's mixed case): x, y, s and the objective."""
    c = np.array([1.0, 1.0, 0.0])
    A = np.array([[1.0, 0.0, 0.0],     # z: x0 = 2
                  [0.0, -1.0, 0.0],    # l: x1 >= 0
                  [-1.0, 0.0, 0.0],    # q: (x0, x2) in SOC(2)
                  [0.0, 0.0, -1.0],
                  [-1.0, 0.0, 0.0],    # s: [[x0, x1], [x1, x2]] PSD
                  [0.0, -np.sqrt(2.0), 0.0],
                  [0.0, 0.0, -1.0]])
    b = np.array([2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    dims = dict(z=1, l=1, q=(2,), s=(2,))
    sj = jx.solve_cone_program(c, A, b, jx.ConeDims(**dims), **CHUNK)
    st = tx.solve_cone_program(c, A, b, dims, **CHUNK, device="cpu")
    _agree(st.result, sj.result)
    assert st.status == sj.status and st.termination_status == \
        sj.termination_status
    for got, want in ((st.x, sj.x), (st.y, sj.y), (st.s, sj.s)):
        np.testing.assert_allclose(got, want, atol=2e-3)
    assert abs(st.objval - sj.objval) <= 2e-4 * (1 + abs(sj.objval))


@pytest.mark.parametrize("build", ["maxcut", "lp", "soc"])
def test_solve_cvxpy_problem_matches_jax(build, monkeypatch):
    """solve_cvxpy_problem through the fake cvxpy: the value and the
    Solution handed to unpack_results (status, primal and dual vectors)
    against the JAX package's."""
    from tests import _fake_cvxpy as fc

    fc.install(monkeypatch)
    from proxsdp_tpu.cvxpy_interface import solve_cvxpy_problem as jsolve
    from proxsdp_tpu_torch.cvxpy_interface import solve_cvxpy_problem as tsolve

    def problem():
        if build == "maxcut":
            return fc.maxcut_scs_problem(tp.README_W)[0]
        return {"lp": fc.bounded_lp_scs_problem,
                "soc": fc.soc_scs_problem}[build]()

    pj, pt = problem(), problem()
    vj = jsolve(pj, tol_gap=1e-5, tol_feasibility=1e-5, **CHUNK)
    vt = tsolve(pt, tol_gap=1e-5, tol_feasibility=1e-5, **CHUNK, device="cpu")
    assert abs(vt - vj) <= 2e-4 * (1 + abs(vj)), (vt, vj)
    assert pt.unpacked.status == pj.unpacked.status == "optimal"
    for key in ("primal_vars", "dual_vars"):
        (kj, aj), = getattr(pj.unpacked, key).items()
        (kt, at), = getattr(pt.unpacked, key).items()
        assert kj == kt
        np.testing.assert_allclose(at, aj, atol=5e-3)


def test_mimo_matches_jax():
    """MIMO detection at n = 5 (side 6, 42 box rows): the status, the
    objective and the decode error equal to the JAX package's."""
    from proxsdp_tpu.models import mimo as jm
    from proxsdp_tpu_torch.models import mimo as tm

    pj, Xj, sj = jm.mimo_problem(0, 5)
    pt, Xt, st = tm.mimo_problem(0, 5)
    rj = jx.solve(pj, jx.Options(**CHUNK))
    rt = tx.solve(pt, tx.Options(**CHUNK), device="cpu")
    _agree(rt, rj)
    assert rt.status == 1
    assert tm.mimo_eval(st, rt.primal[Xt])[1] == jm.mimo_eval(
        sj, rj.primal[Xj])[1]


def test_sensorloc_matches_jax():
    """Sensor localisation at n = 10 (a feasibility problem, objective 0):
    the status, the linear violation max|A x - b| within the solver's own
    bound tol_feasibility (1 + ||b_s||) s_b (preprocess's rhs scale s_b =
    ||b||, b_s = b / s_b: the test the solver declares on), and the sensor
    positions of both packages' solutions as close to the true ones."""
    from proxsdp_tpu.models import sensorloc as js
    from proxsdp_tpu_torch.models import sensorloc as ts

    pj, Xj, xj = js.sensorloc_problem(0, 10)
    pt, Xt, xt = ts.sensorloc_problem(0, 10)
    rj = jx.solve(pj, jx.Options(**CHUNK))
    rt = tx.solve(pt, tx.Options(**CHUNK), device="cpu")
    _agree(rt, rj)
    setup = tx.preprocess(pt)
    bound = tx.Options().tol_feasibility * (1 + setup.norm_b) * setup.rhs_scale
    for r, p in ((rt, pt), (rj, pj)):
        assert np.abs(p.A @ r.primal - p.b).max() <= bound

    def pos_err(X, x_true):
        return np.sqrt(np.mean(np.sum((X[:2, 2:] - x_true) ** 2, axis=0)))

    ej, et = pos_err(rj.primal[Xj], xj), pos_err(rt.primal[Xt], xt)
    assert et <= 2 * ej + 1e-3, (et, ej)


@pytest.mark.parametrize("parser", ["native", "python"])
def test_sdplib_file_matches_jax(parser, tmp_path, monkeypatch):
    """A written .dat-s file through sdplib_problem, read by the port's
    native parser or its Python one: the solve against the JAX package's
    (its Python parser), objective -4."""
    from proxsdp_tpu.models import sdplib as jsd
    from proxsdp_tpu_torch.models import sdplib as tsd

    monkeypatch.setattr(jsd, "_try_native", lambda path: None)
    if parser == "python":
        monkeypatch.setattr(tsd, "_try_native", lambda path: None)
    else:
        assert tsd._try_native(tp.write_sdpa(tmp_path)) is not None
    path = tp.write_sdpa(tmp_path)
    (pj, _), (pt, _) = jsd.sdplib_problem(path), tsd.sdplib_problem(path)
    rj = jx.solve(pj, jx.Options(**CHUNK))
    rt = tx.solve(pt, tx.Options(**CHUNK), device="cpu")
    _agree(rt, rj)
    assert rt.status == 1 and abs(rt.objval + 4.0) < 1e-3


def test_new_modules_leave_jax_out():
    """Importing the port with every module of this slice loads neither jax
    nor the JAX package."""
    code = (
        "import sys, proxsdp_tpu_torch, proxsdp_tpu_torch.api, "
        "proxsdp_tpu_torch.ingest, proxsdp_tpu_torch.cvxpy_interface, "
        "proxsdp_tpu_torch.models.mimo, proxsdp_tpu_torch.models.sensorloc, "
        "proxsdp_tpu_torch.models.sdplib, proxsdp_tpu_torch.utils.native, "
        "proxsdp_tpu_torch.parallel.batch, proxsdp_tpu_torch.kernels\n"
        "from proxsdp_tpu_torch import (solve_sdp, solve_cone_program, "
        "ConeDims, ConeSolution, ivec, ivech, vech, sympackedlen)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'proxsdp_tpu' or m.startswith('proxsdp_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_exports_match_jax():
    """The port exports what proxsdp_tpu/__init__.py:42-71 does."""
    assert set(jx.__all__) <= set(tx.__all__)
    for name in ("ivec", "ivech", "vech", "sympackedlen"):
        v = np.arange(6.0)
        fj, ft = getattr(jx, name), getattr(tx, name)
        arg = 3 if name == "sympackedlen" else (
            np.arange(9.0).reshape(3, 3) if name == "vech" else v)
        assert np.array_equal(np.asarray(fj(arg)), np.asarray(ft(arg))), name
