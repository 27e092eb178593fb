"""Equilibration, the block-equilibration probe and warm starts of the
PyTorch port against the JAX package.

* ``proxsdp_tpu_torch.equilibration`` and ``models/randsdp`` are copies of
  the JAX package's host NumPy modules: D, E and the scaled A, G, b, h, c
  are ``np.array_equal`` on max-cut, randsdp and two small conic programs;
* kernel K3's plain version with a row scale (an equilibrated problem's
  1/E) and a table of several square blocks, through the port's
  ``_residuals_and_gap``, against the JAX function, in f64 and f32;
* the f64 iterates after 50 iterations from one ``init_state`` of
  block-equilibrated and Ruiz-equilibrated randsdp (rtol 1e-9, atol
  1e-11, as tests/test_torch_iteration.py);
* ``_probe_score`` equal on the same results, and a probe at
  ``block_equilibration_probe_iters=200`` -- deep enough to be bound by
  its depth, not by the 20 s a round of each arm may take -- with the same
  rounds, winner, status and objective (1e-6) as the JAX package's;
* an arm that raises is dropped, unless it raised a KernelError;
* ``warm_start=`` from a Result and from an (x, dual_eq, dual_in) tuple:
  iterations equal, objective within 1e-8.
"""

import contextlib
import dataclasses
import functools
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_parity as tp
import chip_smoke
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import equilibration as jeq
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.models import randsdp as jrand
from proxsdp_tpu.ops import linop as jlinop
from proxsdp_tpu.problem import preprocess as j_pre, to_square_form as j_sq
from proxsdp_tpu_torch import convert
from proxsdp_tpu_torch import equilibration as teq
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.models import randsdp as trand
from proxsdp_tpu_torch.ops.linop import build_linop
from proxsdp_tpu_torch.problem import preprocess as t_pre, to_square_form as t_sq

SMALL = dict(seed=2, sides=(3, 4, 3), soc_lens=(3, 5), n_lp=4, rows=12,
             density=0.4)


def _soc_lp(pkg):
    o = pkg.Optimizer()
    s = o.add_soc_var(3)
    (z,) = o.add_free_vars(1)
    o.add_eq_constraint({int(s[1]): 1.0}, 1.0)
    o.add_eq_constraint({int(s[2]): 3.0}, 1.0)
    o.add_ineq_constraint({int(z): -1.0}, -2.0)
    o.set_objective({int(s[0]): 1.0, int(z): 1.0})
    return o.build_problem()


def problem(pkg, name: str):
    if name == "randsdp":
        mod = jrand if pkg is jx else trand
        return mod.randsdp_problem(0, 20, 20)[0]
    if name == "conic":
        return chip_smoke.build_conic_program(
            pkg, chip_smoke.conic_program_data(**SMALL))[0]
    if name == "soc_lp":
        return _soc_lp(pkg)
    return tp.build_problem(pkg, name)


def _dense(M):
    return M.toarray() if sp.issparse(M) else np.asarray(M)


@pytest.mark.parametrize("kind", ["block", "ruiz"])
@pytest.mark.parametrize("name", ["maxcut30", "randsdp", "conic", "soc_lp"])
def test_equilibration_copy_equal(name, kind):
    sj, st = j_pre(problem(jx, name)), t_pre(problem(tx, name))
    if kind == "block":
        ej = jeq.block_equilibrate_host(sj, jx.Options())
        et = teq.block_equilibrate_host(st, tx.Options())
    else:
        ej = jeq.equilibrate_host(sj, jx.Options(equilibration_force=True,
                                                 equilibration_iters=200))
        et = teq.equilibrate_host(st, tx.Options(equilibration_force=True,
                                                 equilibration_iters=200))
    assert np.array_equal(ej.D, et.D) and np.array_equal(ej.E, et.E)
    for f in ("A", "G"):
        assert np.array_equal(_dense(getattr(sj, f)), _dense(getattr(st, f))), f
    for f in ("b", "h", "c", "norm_b", "norm_h", "norm_c"):
        assert np.array_equal(getattr(sj, f), getattr(st, f)), f


def test_randsdp_copy_equal():
    for seed, n, m in ((0, 20, 20), (3, 7, 11)):
        Aj, bj, Cj = jrand.randsdp_data(seed, m, n)
        At, bt, Ct = trand.randsdp_data(seed, m, n)
        assert np.array_equal(Cj, Ct) and bj == bt
        assert all(np.array_equal(Aj[k], At[k]) for k in Aj)
        pj = jrand.randsdp_problem(seed, n, m)[0]
        pt = trand.randsdp_problem(seed, n, m)[0]
        for f in ("c", "b", "h"):
            assert np.array_equal(getattr(pj, f), getattr(pt, f))
        assert np.array_equal(_dense(pj.A), _dense(pt.A))
        assert np.array_equal(_dense(pj.G), _dense(pt.G))


def jstate(host: dict):
    return jsolver.State(**{
        k: (tuple(jnp.asarray(w) for w in v) if k == "warm" else jnp.asarray(v))
        for k, v in host.items()})


@functools.lru_cache(maxsize=None)
def _equilibrated(name: str, kind: str):
    """(JAX square-form setup, port square-form setup, E) after the same
    equilibration (kind "block" or "ruiz") in each package."""
    sj, st = j_pre(problem(jx, name)), t_pre(problem(tx, name))
    if kind == "block":
        e = jeq.block_equilibrate_host(sj, jx.Options())
        teq.block_equilibrate_host(st, tx.Options())
    else:
        e = jeq.equilibrate_host(sj, jx.Options(equilibration_force=True))
        teq.equilibrate_host(st, tx.Options(equilibration_force=True))
    return j_sq(sj), t_sq(st), e.E


def _operands(sj, st, E, jdt=jnp.float64, tdt=torch.float64):
    o_j = jsolver.Operands(
        M=jlinop.build_linop(sj.A, sj.G, jdt), b=jnp.asarray(sj.b, jdt),
        h=jnp.asarray(sj.h, jdt), c=jnp.asarray(sj.c, jdt),
        norm_b=jnp.asarray(sj.norm_b, jdt), norm_h=jnp.asarray(sj.norm_h, jdt),
        norm_c=jnp.asarray(sj.norm_c, jdt), chunk_end=jnp.asarray(0, jnp.int32),
        obj_scale=jnp.asarray(sj.obj_scale * sj.rhs_scale, jdt),
        row_unscale=jnp.asarray(1.0 / E, jdt))
    o_t = convert.operands_from_numpy(
        M=build_linop(st.A, st.G, tdt, device=tp.DEV), b=st.b, h=st.h, c=st.c,
        norm_b=st.norm_b, norm_h=st.norm_h, norm_c=st.norm_c,
        obj_scale=st.obj_scale * st.rhs_scale, device=tp.DEV, dtype=tdt,
        row_unscale=1.0 / E)
    return o_j, o_t


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_residuals_row_scale_and_blocks_match_jax(dtype):
    """K3 with a row scale and three square blocks (two of side 3, one of
    side 4) plus SOC and LP coordinates, on a random state."""
    sj, st, E = _equilibrated("conic", "block")
    layout = sj.layout
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "float64"
                else (jnp.float32, torch.float32))
    jopts, topts = jx.Options(dtype=dtype), tx.Options(dtype=dtype)
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, sj))
    rng = np.random.RandomState(4)
    for f in ("x", "x_old", "y", "y_old", "Mx", "Mx_old", "Mty", "Mty_old"):
        host[f] = rng.randn(*host[f].shape).astype(host[f].dtype)
    host.update(primal_step=host["primal_step"].dtype.type(0.8),
                dual_step=host["dual_step"].dtype.type(0.3), iter=np.int32(7))
    o_j, o_t = _operands(sj, st, E, jdt, tdt)
    want = tp.jax_state_numpy(jsolver._residuals_and_gap(
        jstate(host), o_j, layout, jopts))
    got = convert.state_to_numpy(tsolver._residuals_and_gap(
        convert.state_from_numpy(host, tp.DEV), o_t, layout, topts))
    rtol = 1e-12 if dtype == "float64" else 1e-6
    for f in want:
        if f != "warm":
            np.testing.assert_allclose(got[f], want[f], rtol=rtol, atol=1e-15,
                                       err_msg=f)
    # the row scale moved the feasibility: without it the values differ
    plain = tsolver._residuals_and_gap(
        convert.state_from_numpy(host, tp.DEV),
        dataclasses.replace(o_t, row_unscale=None), layout, topts)
    assert float(plain.equa_feas) != float(got["equa_feas"])


@functools.lru_cache(maxsize=None)
def _stepped(kind: str, k: int):
    sj, st, E = _equilibrated("randsdp", kind)
    layout = sj.layout
    jopts, topts = tp.jax_opts(), tp.torch_opts()
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, sj))
    o_j, o_t = _operands(sj, st, E)
    it_j = tp.jax_iteration(layout, jopts)
    it_t = tsolver.make_chunk_runner(layout, topts, device=tp.DEV)[1]
    s_j, s_t = jstate(host), convert.state_from_numpy(host, tp.DEV)
    for _ in range(k):
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t)
    return convert.state_to_numpy(s_t), tp.jax_state_numpy(s_j)


@pytest.mark.parametrize("k", [1, 50])
@pytest.mark.parametrize("kind", ["block", "ruiz"])
def test_equilibrated_iterates_match_jax(kind, k):
    got, want = _stepped(kind, k)
    assert int(got["iter"]) == k
    tp.assert_states_close(got, want)


def test_probe_score_equal():
    pj, pt = problem(jx, "randsdp"), problem(tx, "randsdp")
    results = [jx.solve(pj, tp.jax_opts(max_iter=mi, block_equilibration=b))
               for mi, b in ((30, False), (60, True))]
    results.append(tx.solve(pt, tp.torch_opts(max_iter=40,
                                              block_equilibration=False),
                            device="cpu"))
    for res in results + [None]:
        assert jsolver._probe_score(res, pj) == tsolver._probe_score(res, pt)
    assert np.isfinite(tsolver._probe_score(results[0], pt))


def _probe_log(log: str):
    rounds = [int(d) for d in re.findall(r"\[beq probe\] depth (\d+):", log)]
    winner = re.search(r"\[beq probe\] -> (\S+)", log).group(1)
    return rounds, winner


def test_probe_matches_jax():
    """randsdp (row-norm spread 159) through the default probe at depth
    200: each arm's round takes a second or two, far inside its 20 s."""
    kw = dict(block_equilibration_probe_iters=200, log_verbose=True,
              log_freq=10**9)
    pj, pt = problem(jx, "randsdp"), problem(tx, "randsdp")
    for beq in (False, True):  # compile both arms' programs first
        jx.solve(pj, tp.jax_opts(max_iter=1, block_equilibration=beq))
    out = {}
    for key, run in (("jax", lambda: jx.solve(pj, tp.jax_opts(**kw))),
                     ("port", lambda: tx.solve(pt, tp.torch_opts(**kw),
                                               device="cpu"))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = run()
        out[key] = (res, _probe_log(buf.getvalue()))
    (rj, lj), (rt, lt) = out["jax"], out["port"]
    assert lt == lj and lj[0][0] == 200
    assert rt.status == rj.status == 1
    assert abs(rt.objval - rj.objval) <= 1e-6 * (1 + abs(rj.objval))


@pytest.mark.parametrize("error", [tx.kernels.KernelError, ValueError])
def test_probe_arm_error(monkeypatch, error):
    """An arm that raises is dropped, as in the JAX package, and the
    default arm finishes the solve; a KernelError (a kernel that does not
    build or launch) propagates instead."""
    real = tx.kernels.residuals

    def failing(*a, row_scale=None, **kw):
        if row_scale is not None:  # the equilibrated arm's
            raise error("residuals with a row scale failed")
        return real(*a, row_scale=row_scale, **kw)

    monkeypatch.setattr(tx.kernels, "residuals", failing)
    pt = problem(tx, "randsdp")
    opts = tp.torch_opts(block_equilibration_probe_iters=50, log_verbose=True,
                         log_freq=10**9)
    if error is tx.kernels.KernelError:
        with pytest.raises(tx.kernels.KernelError):
            tx.solve(pt, opts, device="cpu")
        return
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tx.solve(pt, opts, device="cpu")
    log = buf.getvalue()
    assert "[beq probe] arm True failed" in log
    assert _probe_log(log)[1] == "default"
    assert res.status == 1


@pytest.mark.parametrize("how, name, kw", [
    ("result", "conic", {}),
    ("tuple", "conic", {}),
    ("tuple", "randsdp", {"block_equilibration": True}),
])
def test_warm_start_matches_jax(how, name, kw):
    pj, pt = problem(jx, name), problem(tx, name)
    first_j = jx.solve(pj, tp.jax_opts(max_iter=60, **kw))
    first_t = tx.solve(pt, tp.torch_opts(max_iter=60, **kw), device="cpu")
    assert first_j.status == first_t.status == 3
    if how == "result":
        warm_j, warm_t = first_j, first_t
    else:
        warm_j = warm_t = (first_j.primal, first_j.dual_eq, first_j.dual_in)
    rj = jx.solve(pj, tp.jax_opts(**kw), warm_start=warm_j)
    rt = tx.solve(pt, tp.torch_opts(**kw), warm_start=warm_t, device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iter == rj.iter
    assert abs(rt.objval - rj.objval) <= 1e-8 * (1 + abs(rj.objval))
