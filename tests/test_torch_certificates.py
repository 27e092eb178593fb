"""The certificate search (infeasible and unbounded programs) of the port
against the JAX package's, on the CPU.

The problems are the JAX suite's own (tests/test_solver.py:158-230, the
infeasible / unbounded cases of tests/test_conformance.py's TestLP,
TestSOC and TestPSD, tests/test_conformance_ext.py's
TestInfeasibilityCertificates, tests/test_parallel.py's
TestBatchCertificates); two of them declare at the iteration limit (the
limit-time path).  Both packages run at ``chunk_iters=256`` (the JAX
driver sizes its chunks from measured rates otherwise, and a
declaration's iteration moves with the chunk: ROADMAP C9) and on a
frozen clock (``frozen_clock``).  Under f64-only options compared: the
status, ``certificate_found``, the status string, the first
declaration's status and iteration (the port's log against the JAX
``certificate_search=False`` solve), the final iteration within 5 % and
the returned ray (the duals of an infeasibility certificate, the primal
of an unboundedness one) as a direction within 1e-6.  Under the default
hybrid ``Options()`` the f32 race's sums run in other orders in the two
packages, which moves the hand-over and the f64 declaration by a few
percent, so there only the status, the flag and the string must agree.
The five unbounded programs of ``FMA_APART`` part at an FMA that XLA:CPU
puts in the box projection: their f64 runs are held in full to the JAX
package run without FMA in a child process, and on the status, the flag
and the string to its usual build.

Then the trial loop: ``kernels.linesearch_loop_plain`` (and the batched
one) against the JAX ``_linesearch`` on crafted states that take one,
several and ``max_linsearch_steps`` trials.
"""

import functools
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.parallel import batch as jbatch
from proxsdp_tpu.problem import preprocess as jpreprocess
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.parallel import batch as tbatch

CHUNK = 256
README_W = tp.README_W
TESTS = pathlib.Path(__file__).resolve().parent


# ---------------------------------------------------------------------------
# The JAX suite's certificate problems, built through either package
# ---------------------------------------------------------------------------


def _conflicting_diag(pkg):
    # test_solver.py::test_infeasible: X_00 = 1 and X_00 = 2
    opt = pkg.Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, 2.0)
    opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
    return opt.build_problem()


def _free_below(pkg):
    # test_solver.py::test_unbounded: min -x s.t. x >= 1
    opt = pkg.Optimizer()
    opt.add_free_vars(1)
    opt.add_ineq_constraint({0: -1.0}, -1.0)
    opt.set_objective({0: -1.0}, sense="min")
    return opt.build_problem()


def _negative_diag(pkg):
    # test_solver.py::test_infeasible_sdp_dual_ray (and search disabled):
    # X psd with X_00 = -1
    opt = pkg.Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, -1.0)
    opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
    return opt.build_problem()


def _lp_ray(pkg):
    # test_solver.py::test_unbounded_lp_primal_ray: min x s.t. x <= 0
    opt = pkg.Optimizer()
    opt.add_free_vars(1)
    opt.add_ineq_constraint({0: 1.0}, 0.0)
    opt.set_objective({0: 1.0}, sense="min")
    return opt.build_problem()


def _readme_maxcut(pkg):
    # test_solver.py::test_no_false_infeasible_without_certificate
    opt = pkg.Optimizer()
    X = opt.add_psd_var(4)
    for i in range(4):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * README_W),
                      sense="max")
    return opt.build_problem()


def _lp_infeasible(pkg):
    # test_conformance.py::TestLP::test_infeasible: x <= 0 and x >= 1
    opt = pkg.Optimizer()
    (x,) = opt.add_free_vars(1)
    opt.add_ineq_constraint({int(x): 1.0}, 0.0)
    opt.add_ineq_constraint({int(x): -1.0}, -1.0)
    opt.set_objective({int(x): 1.0})
    return opt.build_problem()


def _lp_unbounded(pkg):
    # TestLP::test_unbounded: min -x s.t. x >= 0
    opt = pkg.Optimizer()
    (x,) = opt.add_free_vars(1)
    opt.add_ineq_constraint({int(x): -1.0}, 0.0)
    opt.set_objective({int(x): -1.0})
    return opt.build_problem()


def _soc_infeasible(pkg):
    # TestSOC::test_infeasible: t <= -1 with ||v|| <= t
    opt = pkg.Optimizer()
    s = opt.add_soc_var(3)
    opt.add_ineq_constraint({int(s[0]): 1.0}, -1.0)
    opt.set_objective({int(s[0]): 1.0})
    return opt.build_problem()


def _psd_infeasible(pkg):
    # TestPSD::test_infeasible: X_11 = -1, X psd, min tr X
    opt = pkg.Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, -1.0)
    opt.set_objective({int(X[0, 0]): 1.0, int(X[1, 1]): 1.0})
    return opt.build_problem()


def _psd_unbounded(pkg):
    # TestPSD::test_unbounded: X_22 = 1, min -X_11
    opt = pkg.Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
    opt.set_objective({int(X[0, 0]): -1.0})
    return opt.build_problem()


def _eq_infeasible(pkg):
    # test_conformance_ext.py::test_eq_infeasible_certificate_flag:
    # x + y = 1 and x + y = 2
    opt = pkg.Optimizer()
    x, y = (int(v) for v in opt.add_free_vars(2))
    opt.add_eq_constraint({x: 1.0, y: 1.0}, 1.0)
    opt.add_eq_constraint({x: 1.0, y: 1.0}, 2.0)
    opt.set_objective({x: 1.0})
    return opt.build_problem()


def _below_one(pkg):
    # test_conformance_ext.py::test_unbounded_certificate_flag: min z,
    # z <= 1
    opt = pkg.Optimizer()
    (z,) = (int(v) for v in opt.add_free_vars(1))
    opt.add_ineq_constraint({z: 1.0}, 1.0)
    opt.set_objective({z: 1.0})
    return opt.build_problem()


# test_conformance.py's infeas_opt / the _ext file's knobs
INFEAS = dict(max_iter=20_000, infeas_gap_tol=0.3, infeas_stable_gap_tol=1e-2)
# test_no_false_infeasible_without_certificate's mis-detection knobs
MISFIRE = dict(min_iter_max_obj=8, infeas_limit_gap_tol=0.0,
               infeas_feasibility_tol=1e-12,
               infeas_stable_feasibility_tol=1e10, max_iter=300,
               tol_gap=1e-12, tol_feasibility=1e-12)

CASES = [
    # (id, build, options, the ray to compare).  "infeasible" and
    # "eq_infeasible" run at max_iter 3000 instead of their tests' 20,000
    # and 200,000: they declare at the iteration limit (the limit-time
    # path, _limit_status) there too, and the port's CPU path takes ~2 ms
    # an iteration on them
    ("infeasible", _conflicting_diag, dict(max_iter=3000), "dual"),
    ("unbounded", _free_below, dict(max_iter=20_000), "primal"),
    ("dual_ray", _negative_diag, {}, "dual"),
    ("primal_ray", _lp_ray, {}, "primal"),
    ("search_disabled", _negative_diag, dict(certificate_search=False), None),
    ("no_false_infeasible", _readme_maxcut, MISFIRE, None),
    ("lp_infeasible", _lp_infeasible, INFEAS, "dual"),
    ("lp_unbounded", _lp_unbounded, INFEAS, "primal"),
    ("soc_infeasible", _soc_infeasible, INFEAS, "dual"),
    ("psd_infeasible", _psd_infeasible, INFEAS, "dual"),
    ("psd_unbounded", _psd_unbounded, INFEAS, "primal"),
    ("eq_infeasible", _eq_infeasible, dict(INFEAS, max_iter=3000), "dual"),
    ("below_one", _below_one, INFEAS, "primal"),
]
# Unbounded programs whose dual is 0: the box projection's y_half - bp *
# (y_half / bp) is exactly 0 in the port (and in the reference), while
# XLA:CPU contracts it into an FMA, which leaves the division's rounding
# error (~1e-16).  With dy = 0 the linesearch accepts any step (0 <= 0),
# so the port's primal grows geometrically and declares through max_obj
# within ~100 iterations where the JAX run grows linearly and declares up
# to 11,753 iterations in (ROADMAP C17).  Their f64 runs are held in full
# to the JAX package built without FMA (``_jax_without_fma``), and to its
# usual build on the status, the flag and the string.
FMA_APART = {"unbounded", "primal_ray", "lp_unbounded", "below_one",
             "psd_unbounded"}
# psd_unbounded's primal grows to ~1e18: the two packages' 2x2
# eigendecompositions part in the last bit from iteration 2 and the growth
# carries that to the first declaration (313 in the port, 319 in the JAX
# package without FMA), which is held within 5 % like the final iteration
DECL_RTOL = {"psd_unbounded": 0.05}


class _FrozenClock:
    """A clock that never moves, for both drivers' modules: the
    best-iterate snapshots (rate-limited to one per 2 s), the search's
    clock deadline and the JAX chunk controller read the wall clock, and
    the port runs ~20x slower on the CPU, so with a moving clock the two
    take their snapshots -- the point a failed search resumes from -- at
    other iterations."""

    @staticmethod
    def time():
        return 0.0


@pytest.fixture
def frozen_clock(monkeypatch):
    for mod in (jsolver, tsolver, jbatch, tbatch):
        monkeypatch.setattr(mod, "time", _FrozenClock)


def _ray(res, kind):
    v = (np.concatenate([res.dual_eq, res.dual_in]) if kind == "dual"
         else res.primal)
    return v / max(np.abs(v).max(), 1e-300)


def _string(res):
    # a limit status's best iterate comes with its violation, which the
    # two runs may read from other snapshots
    return res.status_string.split(" (infeasible iterate")[0]


def _reference(build, kw, ray, full=True):
    """The JAX runs a port solve is held to: the status, the flag, the
    string and, if ``full``, the final iteration, the first declaration
    [status, iteration] (where the solve without a search stops; [] if it
    declares none, None with the search off) and the ray scaled to max
    norm 1 (None without one)."""
    r = jx.solve(build(jx), jx.Options(chunk_iters=CHUNK, **kw))
    out = dict(status=int(r.status), found=bool(r.certificate_found),
               string=_string(r), iter=int(r.iter), decl=None, ray=None)
    if full and kw.get("certificate_search", True):
        d = jx.solve(build(jx), jx.Options(chunk_iters=CHUNK,
                                            certificate_search=False, **kw))
        out["decl"] = [int(d.status), int(d.iter)] if d.status in (5, 6) else []
    if full and ray is not None and r.certificate_found:
        out["ray"] = _ray(r, ray).tolist()
    return out


# FMA_APART's JAX runs in a child process whose XLA:CPU code stops at AVX,
# which has no FMA instruction: the box projection then rounds as the
# port's does (y_half - bp * (y_half / bp) is 0 where numpy's is)
NO_FMA_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import test_torch_certificates as tc

tc.jsolver.time = tc._FrozenClock
print(json.dumps({name: tc._reference(build, dict(kw, hybrid_precision=False),
                                      ray)
                  for name, build, kw, ray in tc.CASES
                  if name in tc.FMA_APART}))
"""


@functools.lru_cache(maxsize=1)
def _jax_without_fma() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
        [os.environ.get("XLA_FLAGS", ""), "--xla_cpu_max_isa=AVX"]).strip())
    proc = subprocess.run([sys.executable, "-c", NO_FMA_CHILD, str(TESTS)],
                          cwd=TESTS.parent, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_box_projection_without_fma_rounds_as_the_port():
    """The cause of FMA_APART: the box projection's y - bp * (y / bp)
    under jit equals the port's (torch) bit for bit in the XLA:CPU build
    without FMA, and not in the usual one, which leaves more of it
    non-zero."""
    code = r"""
import jax, jax.numpy as jnp, numpy as np, torch
jax.config.update("jax_enable_x64", True)
rng = np.random.default_rng(0)
y, bp = rng.standard_normal(3000), 3.0 * rng.standard_normal(3000)
r = np.asarray(jax.jit(lambda y, b: y - b * (y / b))(jnp.asarray(y),
                                                     jnp.asarray(bp)))
ty, tb = torch.tensor(y), torch.tensor(bp)
print(int(np.array_equal(r, (ty - tb * (ty / tb)).numpy())),
      int(np.count_nonzero(r)))
"""
    out = {}
    for tag, flags in (("fma", ""), ("no_fma", "--xla_cpu_max_isa=AVX")):
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=" ".join(
            [os.environ.get("XLA_FLAGS", ""), flags]).strip())
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        out[tag] = [int(v) for v in proc.stdout.split()]
    assert out["no_fma"][0] == 1 and out["fma"][0] == 0, out
    assert out["no_fma"][1] < out["fma"][1], out


def _port(build, kw, capsys):
    """(port Result, its declarations [(status, iter)] from its log)."""
    capsys.readouterr()
    got = tx.solve(build(tx), tx.Options(chunk_iters=CHUNK, log_verbose=True,
                                           log_freq=10**9, **kw),
                   device="cpu")
    decl = [[int(a), int(b)] for a, b in re.findall(
        r"\[cert\] status (\d) at iter (\d+)", capsys.readouterr().out)]
    return got, decl


@pytest.mark.parametrize("hybrid", [False, True], ids=["f64", "hybrid"])
@pytest.mark.parametrize("name, build, kw, ray", CASES,
                         ids=[c[0] for c in CASES])
def test_certificates_match_jax(name, build, kw, ray, hybrid, capsys,
                                frozen_clock):
    kw = dict(kw, hybrid_precision=hybrid)
    got, decl = _port(build, kw, capsys)
    apart = name in FMA_APART
    refs = [_reference(build, kw, ray, full=not (hybrid or apart))]
    if apart and not hybrid:
        refs.append(_jax_without_fma()[name])
    for want in refs:
        assert got.status == want["status"], (got.status_string,
                                              want["string"])
        assert got.certificate_found == want["found"]
        assert _string(got) == want["string"]
    if hybrid:
        return
    want = refs[-1]
    assert abs(got.iter - want["iter"]) <= max(2, 0.05 * want["iter"]), (
        got.iter, want["iter"])
    if want["decl"] is not None:
        if want["decl"]:
            assert decl and decl[0][0] == want["decl"][0], (decl, want)
            assert abs(decl[0][1] - want["decl"][1]) <= (
                DECL_RTOL.get(name, 0.0) * want["decl"][1]), (decl, want)
        else:
            assert not decl
    if want["ray"] is None:
        return
    # a ray is a direction: compared after scaling to max norm 1
    np.testing.assert_allclose(_ray(got, ray), want["ray"], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The batch's re-entry (test_parallel.py::TestBatchCertificates)
# ---------------------------------------------------------------------------


def _feasible_diag(pkg):
    opt = pkg.Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
    return opt.build_problem()


@pytest.mark.parametrize("search", [True, False], ids=["search", "disabled"])
def test_batch_certificates_match_jax(search, frozen_clock):
    kw = dict(hybrid_precision=False, max_iter=20_000, chunk_iters=CHUNK,
              certificate_search=search)
    want = jbatch.solve_batch([_feasible_diag(jx), _negative_diag(jx)],
                              jx.Options(**kw))
    got = tbatch.solve_batch([_feasible_diag(tx), _negative_diag(tx)],
                             tx.Options(**kw), device="cpu")
    for g, w in zip(got, want):
        assert g.status == w.status, (g.status_string, w.status_string)
        assert g.certificate_found == w.certificate_found
        assert g.status_string == w.status_string
        assert abs(g.iter - w.iter) <= max(2, 0.05 * w.iter)
    assert got[0].status == 1 and got[1].status == 6
    assert got[1].certificate_found == search


# ---------------------------------------------------------------------------
# The trial loop against the JAX _linesearch
# ---------------------------------------------------------------------------


def _ls_state(rng, pm, scale):
    """A state whose first trial's step is ``scale`` times the accepted
    one on an operator of norm ~1 (max-cut at side 10: M' is an
    injection): about log(scale) / log(4/3) refusals."""
    return dict(
        y=rng.standard_normal(pm), y_old=rng.standard_normal(pm),
        Mx=rng.standard_normal(pm), Mx_old=rng.standard_normal(pm),
        primal_step=np.float64(scale), primal_step_old=np.float64(scale),
        theta=np.float64(1.0), beta=np.float64(1.0))


TRIAL_CASES = [("one", 0.3, 5000), ("several", 6.0, 5000),
               ("max_steps", 1e6, 7)]


def _jax_linesearch(setup, fields, opts_kw):
    layout = setup.layout
    o = tp.jax_operands(setup)
    base = jsolver.init_state(layout, jx.Options(hybrid_precision=False),
                              setup)
    s = jax.tree_util.tree_map(jnp.asarray, base)
    s = s._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    s = s._replace(Mty_old=o.M.rmatvec(s.y_old))
    opts = jx.Options(hybrid_precision=False, **opts_kw)
    out = jax.jit(lambda s_, o_: jsolver._linesearch(s_, o_, layout, opts))(s, o)
    return o, s, out


@pytest.mark.parametrize("case, scale, steps", TRIAL_CASES,
                         ids=[c[0] for c in TRIAL_CASES])
def test_linesearch_loop_matches_jax(case, scale, steps):
    setup = tp.jax_setup("maxcut10")
    layout = setup.layout
    rng = np.random.default_rng(7)
    fields = _ls_state(rng, layout.p + layout.m, scale)
    o_j, s_j, want = _jax_linesearch(setup, fields,
                                     dict(max_linsearch_steps=steps))
    o_t = tp.torch_operands_from_jax(o_j, setup)
    args = [torch.tensor(np.asarray(getattr(s_j, f)))
            for f in ("y", "Mx", "Mx_old")]
    y_temp, Mty, theta, ps, trials = kernels.linesearch_loop_plain(
        o_t.M, *args, o_t.b, o_t.h, torch.tensor(np.asarray(s_j.y_old)),
        torch.tensor(np.asarray(s_j.Mty_old)),
        *(torch.tensor(np.asarray(getattr(s_j, f))) for f in
          ("primal_step", "primal_step_old", "theta", "beta")),
        layout.p, layout.m, 0.9999, 0.75, steps)
    np.testing.assert_allclose(y_temp.numpy(), np.asarray(want.y), rtol=1e-13,
                               atol=1e-14)
    np.testing.assert_allclose(Mty.numpy(), np.asarray(want.Mty), rtol=1e-13,
                               atol=1e-14)
    assert float(theta) == pytest.approx(float(want.theta), rel=1e-14)
    assert float(ps) == pytest.approx(float(want.primal_step), rel=1e-14)
    # the trials the JAX loop ran: ps0 * decay^(refused) = its final ps
    ps0 = float(s_j.primal_step) * np.sqrt(1.0 + float(s_j.theta))
    refused = round(np.log(float(want.primal_step) / ps0) / np.log(0.75))
    n_trials = int(trials)
    if case == "one":
        assert n_trials == 1 and refused == 0
    elif case == "several":
        assert 3 <= n_trials < steps and refused == n_trials - 1
    else:
        assert n_trials == steps and refused == steps


def test_linesearch_loop_batch_matches_jax():
    """The batched loop over 8 instances of side 10 with per-instance
    step scales (one, several and max_linsearch_steps trials) and two
    inactive instances: the active ones equal the vmapped JAX loop, the
    inactive ones keep their values."""
    B, steps = 8, 12
    setups = [jpreprocess(p) for p in
              (tp.jmaxcut.maxcut_problem(tp.jmaxcut.random_graph_weights(s, 10))[0]
               for s in range(B))]
    layout = setups[0].layout
    opts_j = jbatch._force_batch_options(jx.Options(
        hybrid_precision=False, max_linsearch_steps=steps))
    ops_j, _ = jbatch._batch_operands(setups, jnp.float64)
    states = jbatch._stack_states(
        [jbatch.init_state(layout, opts_j, s) for s in setups])
    rng = np.random.default_rng(11)
    pm, n = layout.p + layout.m, layout.n
    scales = np.array([0.3, 3.0, 1e6, 2.0, 0.5, 40.0, 1e5, 1.0])
    kw = dict(y=rng.standard_normal((B, pm)), y_old=rng.standard_normal((B, pm)),
              Mx=rng.standard_normal((B, pm)),
              Mx_old=rng.standard_normal((B, pm)),
              Mty=rng.standard_normal((B, n)),
              primal_step=scales, primal_step_old=scales,
              theta=np.ones(B), beta=np.ones(B))
    states = states._replace(**{k: jnp.asarray(v) for k, v in kw.items()})
    M = ops_j.M
    states = states._replace(Mty_old=jax.vmap(M.rmatvec)(states.y_old))
    want = jax.jit(jax.vmap(
        lambda s_, b_, h_: jsolver._linesearch(
            s_, ops_j._replace(b=b_, h=h_), layout, opts_j),
        in_axes=(0, 0, 0)))(states, ops_j.b, ops_j.h)
    active = np.array([True, True, True, False, True, True, False, True])
    o_t = tbatch._batch_operands([tbatch.preprocess(p) for p in
                                  (tp.tmaxcut.maxcut_problem(
                                      tp.tmaxcut.random_graph_weights(s, 10))[0]
                                   for s in range(B))],
                                 torch.float64, "cpu", "auto")
    s_t = convert.state_from_numpy(tp.jax_state_numpy(states), "cpu")
    y_temp, Mty, theta, ps, trials = kernels.linesearch_loop_batch_plain(
        o_t.M, s_t.y, s_t.Mx, s_t.Mx_old, o_t.b, o_t.h, s_t.y_old, s_t.Mty,
        s_t.Mty_old, s_t.primal_step, s_t.primal_step_old, s_t.theta,
        s_t.beta, torch.tensor(active), layout.p, layout.m, 0.9999, 0.75,
        steps)
    a = active
    for got, w, keep in ((y_temp, want.y, kw["y"]), (Mty, want.Mty, kw["Mty"]),
                         (theta, want.theta, kw["theta"]),
                         (ps, want.primal_step, scales)):
        got = got.numpy()
        np.testing.assert_allclose(got[a], np.asarray(w)[a], rtol=1e-13,
                                   atol=1e-14)
        np.testing.assert_array_equal(got[~a], np.asarray(keep)[~a])
    tr = trials.numpy()
    assert tr[0] == 1 and 1 < tr[1] < steps and tr[2] == steps
    assert tr[3] == tr[6] == 0
