"""The conformance battery's ingestion, attribute, certificate and CVXPY
cases through the port.

Each class but the CVXPY one subclasses its JAX test class
(tests/test_conformance.py, tests/test_conformance_ext.py) and runs the
same case, with the same known answer, against the port's API on the CPU
(``_torch_conformance``).  The CVXPY cases import the JAX package's
``cvxpy_interface`` inside their bodies, so ``TestCvxpyInterface`` here is
their port version: the same cases through
``proxsdp_tpu_torch.cvxpy_interface`` on the CPU, against
``tests/_fake_cvxpy.py`` (cvxpy is not installed).
"""

import functools

import numpy as np
import pytest

import _torch_conformance as tc
import test_conformance as jc
import test_conformance_ext as jce

_bind_port = tc.port_fixture(jc, jce)


class TestConeProgramIngestion(jc.TestConeProgramIngestion):
    pass


class TestMOIAttributeSurface(jc.TestMOIAttributeSurface):
    pass


class TestInfeasibilityCertificates(jce.TestInfeasibilityCertificates):
    @pytest.mark.slow
    def test_eq_infeasible_certificate_flag(self):
        """The same case, marked slow: conflicting equalities with the
        certificate search take ~560 s on the port's CPU path (its
        200,000-iteration budget at ~2.7 ms an iteration)."""
        super().test_eq_infeasible_certificate_flag()


class TestIngestionExt(jce.TestIngestionExt):
    pass


class TestAttributesExt(jce.TestAttributesExt):
    pass


def _port_cvxpy(monkeypatch):
    """The fake cvxpy installed, and the port's solve_cvxpy_problem on the
    CPU."""
    from tests import _fake_cvxpy as fc

    fc.install(monkeypatch)
    from proxsdp_tpu_torch.cvxpy_interface import solve_cvxpy_problem

    return fc, functools.partial(solve_cvxpy_problem, device="cpu")


W4 = np.array([[18.0, -5, -7, -6], [-5, 6, 0, -1], [-7, 0, 8, -1],
               [-6, -1, -1, 8]])


class TestCvxpyInterface:
    """The port version of tests/test_conformance.py::TestCvxpyInterface."""

    def test_import_error_message(self):
        import importlib

        cv = importlib.util.find_spec("cvxpy")
        from proxsdp_tpu_torch import cvxpy_interface

        if cv is None:
            with pytest.raises(ImportError, match="cvxpy"):
                cvxpy_interface._require_cvxpy()
        else:
            assert cvxpy_interface._require_cvxpy() is not None

    def test_maxcut_through_cvxpy(self):
        cvxpy = pytest.importorskip("cvxpy")
        from proxsdp_tpu_torch.cvxpy_interface import solve_cvxpy_problem

        X = cvxpy.Variable((4, 4), PSD=True)
        prob = cvxpy.Problem(cvxpy.Maximize(cvxpy.trace(0.25 * W4 @ X)),
                             [cvxpy.diag(X) == 1])
        val = solve_cvxpy_problem(prob, tol_gap=1e-5, tol_feasibility=1e-5,
                                  device="cpu")
        if hasattr(val, "objval"):  # schema-fallback path
            val = val.objval
        assert abs(val - 18.0) < 0.05

    def test_fake_maxcut_value_and_unpack(self, monkeypatch):
        fc, solve_cvxpy_problem = _port_cvxpy(monkeypatch)
        prob, tri = fc.maxcut_scs_problem(W4)
        val = solve_cvxpy_problem(prob, tol_gap=1e-5, tol_feasibility=1e-5)
        assert abs(val - 18.0) < 0.05
        raw = prob.unpacked
        assert raw.status == "optimal"
        x = raw.primal_vars["x"]
        X = np.zeros((4, 4))
        for k, (i, j) in enumerate(tri):
            v = x[k] if i == j else x[k] / np.sqrt(2.0)
            X[i, j] = X[j, i] = v
        assert np.allclose(np.diag(X), 1.0, atol=1e-3)
        assert np.linalg.eigvalsh(X).min() > -1e-4
        assert raw.attr["num_iters"] > 0

    def test_fake_lp_dual_values(self, monkeypatch):
        fc, solve_cvxpy_problem = _port_cvxpy(monkeypatch)
        prob = fc.bounded_lp_scs_problem()
        val = solve_cvxpy_problem(prob, tol_gap=1e-6, tol_feasibility=1e-6)
        assert abs(val - 1.0) < 1e-3
        y = prob.unpacked.dual_vars["y"]
        assert abs(y[0] - 1.0) < 1e-3
        sol = tc.solve_cone_program(
            prob._data["c"], prob._data["A"], prob._data["b"],
            dict(l=1), tol_gap=1e-6, tol_feasibility=1e-6,
        )
        assert np.allclose(y, sol.y, atol=1e-6)

    def test_fake_soc(self, monkeypatch):
        fc, solve_cvxpy_problem = _port_cvxpy(monkeypatch)
        prob = fc.soc_scs_problem()
        val = solve_cvxpy_problem(prob, tol_gap=1e-6, tol_feasibility=1e-6)
        assert abs(val - 5.0) < 1e-3

    def test_fake_soc_dual_round_trip(self, monkeypatch):
        fc, solve_cvxpy_problem = _port_cvxpy(monkeypatch)
        prob = fc.soc_scs_problem()
        solve_cvxpy_problem(prob, tol_gap=1e-6, tol_feasibility=1e-6)
        y = np.asarray(prob.unpacked.dual_vars["y"])
        assert np.allclose(y, [1.0, -0.6, -0.8], atol=1e-3), y
        A = prob._data["A"].toarray()
        c, b = prob._data["c"], prob._data["b"]
        assert np.abs(A.T @ y + c).max() < 1e-3
        assert abs(-(b @ y) - 5.0) < 1e-2

    def test_fake_maxcut_psd_dual_round_trip(self, monkeypatch):
        fc, solve_cvxpy_problem = _port_cvxpy(monkeypatch)
        prob, tri = fc.maxcut_scs_problem(W4)
        val = solve_cvxpy_problem(prob, tol_gap=1e-6, tol_feasibility=1e-6)
        y = np.asarray(prob.unpacked.dual_vars["y"])
        A = np.asarray(prob._data["A"].todense())
        c, b = prob._data["c"], prob._data["b"]
        assert np.abs(A.T @ y + c).max() < 5e-3
        n = W4.shape[0]
        S = np.zeros((n, n))
        for k, (i, j) in enumerate(tri):
            v = y[n:][k] if i == j else y[n:][k] / np.sqrt(2.0)
            S[i, j] = S[j, i] = v
        assert np.linalg.eigvalsh(S).min() > -1e-4
        assert abs(-(b @ y) - (-val)) < 5e-2

    def test_fake_infeasible_failure_solution(self, monkeypatch):
        fc, solve_cvxpy_problem = _port_cvxpy(monkeypatch)
        prob = fc.infeasible_lp_scs_problem()
        solve_cvxpy_problem(prob, max_iter=20_000, infeas_gap_tol=0.3,
                            infeas_stable_gap_tol=1e-2)
        assert prob.status in ("infeasible", "infeasible_or_unbounded")
        assert prob.value == np.inf

    def test_fake_rejects_exp_cone(self, monkeypatch):
        fc, solve_cvxpy_problem = _port_cvxpy(monkeypatch)
        prob = fc.bounded_lp_scs_problem()
        prob._data["dims"].exp = 1
        with pytest.raises(ValueError, match="exponential/power"):
            solve_cvxpy_problem(prob)
