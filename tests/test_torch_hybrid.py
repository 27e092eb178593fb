"""The port's default solve -- the hybrid f32 race and f64 polish -- and
its f32 and subspace programs, against the JAX package.

Whole solves run with ``chunk_iters=256``: the JAX driver otherwise sizes
its chunks from measured rates, so its hand-over points (taken at chunk
boundaries) move with the clock; 256 is the port's fixed chunk.  Each case
needs the same status, |obj difference| <= 1e-4 * (1 + |obj|) (the
solver's gap tolerance), |iteration difference| <= max(5, 5 %), and the
same ``[hybrid]`` event lines of ``log_verbose``.

Observed when written (port vs JAX, one thread each): the same
iterations and event lines in every case -- side 100 default: 499
iterations, race subspace rank 16 (observed 7) at 256, hand-over at 498,
polish rank 16 (observed 6), objective difference 1.9e-4 (6e-7
relative), 74 polar reseeds against JAX's 75; side 50 (no polar phase,
side < polar_min_side): 385 iterations, objective difference 1.3e-4;
polar_fallback_min_side=64: as the default case (no polish fallback
fires).  The f32 residual reductions match the JAX f32 program to 1 ulp
of f32 in every ring value.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver

CASES = [
    ("maxcut100", {}),
    ("maxcut50", {}),  # the race has no polar phase below polar_min_side
    ("maxcut100", {"polar_fallback_min_side": 64}),  # polish_fb = polar
    ("readme", {}),
    ("maxcut50", {"hybrid_precision": False, "dtype": "float32"}),
    ("maxcut50", {"hybrid_precision": False, "subspace_rank": 16}),
    ("maxcut50", {"hybrid_precision": False, "projection": "polar",
                  "polar_min_side": 50}),
]
IDS = ["default100", "default50", "polar_polish_fb", "readme", "float32",
       "subspace_f64", "polar_f64"]

EVENT = re.compile(r"^\s+\[hybrid\].*$", re.M)


@pytest.mark.parametrize("name, kw", CASES, ids=IDS)
def test_solve_matches_jax(name, kw, capsys):
    opts = dict(chunk_iters=256, log_verbose=True, **kw)
    kernels.reset_launch_counts()
    want = jx.solve(tp.build_problem(jx, name), jx.Options(**opts))
    want_log = capsys.readouterr().out
    got = tx.solve(tp.build_problem(tx, name), tx.Options(**opts), device=tp.DEV)
    got_log = capsys.readouterr().out
    assert got.status == want.status == 1, (got.status_string, want.status_string)
    assert abs(got.objval - want.objval) <= 1e-4 * (1 + abs(want.objval))
    assert abs(got.iter - want.iter) <= max(5, 0.05 * want.iter)
    assert EVENT.findall(got_log) == EVENT.findall(want_log)
    assert got.primal.shape == want.primal.shape
    assert all(v == 0 for v in kernels.launch_counts.values())


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_solve_pins_ieee_f32_products(precision):
    """A caller's float32 matmul precision does not reach the solve and is
    back in place after it.  On the CPU "medium" makes torch's f32
    products bf16: without the pin the side-50 default solve took 2611
    iterations instead of 385 (observed when written)."""
    problem = tp.build_problem(tx, "maxcut50")
    opts = tx.Options(chunk_iters=256)
    want = tx.solve(problem, opts, device=tp.DEV)
    torch.set_float32_matmul_precision(precision)
    try:
        got = tx.solve(problem, opts, device=tp.DEV)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision("highest")
    assert (got.status, got.iter, got.objval) == (want.status, want.iter,
                                                   want.objval)
    np.testing.assert_array_equal(got.primal, want.primal)


@pytest.mark.parametrize("name", ["maxcut50", "maxcut30"])
def test_residuals_and_gap_f32_matches_jax(name):
    """The f32 program's residuals and gap: f32 maxima, two-stage dots
    (128-element f32 chunks, f64 sum of the chunks), the formulas in f64,
    the ring writes in f32 (solver.py:493-637)."""
    setup = tp.jax_setup(name)
    layout = setup.layout
    jopts, topts = jx.Options(dtype="float32"), tx.Options(dtype="float32")
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, setup))
    rng = np.random.RandomState(11)
    for f in ("x", "x_old", "y", "y_old", "Mx", "Mx_old", "Mty", "Mty_old"):
        host[f] = rng.randn(*host[f].shape).astype(np.float32)
    host.update(primal_step=np.float32(0.8), dual_step=np.float32(0.3),
                iter=np.int32(7))
    o_j = tp.jax_operands(setup, jnp.float32)
    want = tp.jax_state_numpy(jsolver._residuals_and_gap(
        jsolver.State(**{k: jnp.asarray(v) if k != "warm" else v
                         for k, v in host.items()}), o_j, layout, jopts))
    o_t = tp.torch_operands_from_jax(o_j, setup, torch.float32)
    got = convert.state_to_numpy(tsolver._residuals_and_gap(
        convert.state_from_numpy(host, tp.DEV), o_t, layout, topts))
    for f in want:
        if f == "warm":
            continue
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.dtype == w.dtype, f
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=f)


def test_chunk_dot_is_two_stage():
    """The f32 dot of K3's plain version against a float64 transcription of
    the JAX two-stage sum: chunk sums of f32 products, then f64."""
    rng = np.random.RandomState(2)
    a = rng.randn(1000).astype(np.float32)
    b = rng.randn(1000).astype(np.float32)
    prod = np.concatenate([a * b, np.zeros(24, np.float32)]).reshape(-1, 128)
    want = float(np.sum(prod.astype(np.float64).sum(axis=1)))
    got = float(kernels._chunk_dot(torch.tensor(a),
                                   torch.tensor(b)))
    # each chunk's f32 sum is within 128 * eps32 of the exact sum
    assert abs(got - want) <= 128 * 6e-8 * np.abs(a * b).sum()
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    assert abs(got - exact) <= 128 * 6e-8 * np.abs(a * b).sum()


@pytest.mark.parametrize("kw", [{}, {"line_search_flag": False}],
                         ids=["linesearch", "fixed_step"])
def test_f32_iterations_stay_f32_and_match_jax(kw):
    """20 iterations of the f32 program (dense eigh, side 30) from one
    init_state: every float field stays f32 -- no f64 literal promotes a
    0-d scalar of _linesearch, _dual_step or _control -- and agrees with
    the JAX f32 program to 1e-4 of each field's largest entry (at least
    1): two LAPACK builds' f32 eighs and f32 sums in other orders."""
    setup = tp.jax_setup("maxcut30")
    layout = setup.layout
    jopts = jx.Options(dtype="float32", hybrid_precision=False, **kw)
    topts = tx.Options(dtype="float32", hybrid_precision=False, **kw)
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, setup))
    o_j = tp.jax_operands(setup, jnp.float32)
    o_t = tp.torch_operands_from_jax(o_j, setup, torch.float32)
    it_j = tp.jax_iteration(layout, jopts)
    it_t = tsolver.make_chunk_runner(layout, topts, device=tp.DEV)[1]
    s_j = jsolver.State(**{k: (tuple(jnp.asarray(w) for w in v) if k == "warm"
                               else jnp.asarray(v)) for k, v in host.items()})
    s_t = convert.state_from_numpy(host, tp.DEV)
    for k in range(20):
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t, k)
    got, want = convert.state_to_numpy(s_t), tp.jax_state_numpy(s_j)
    for name, w in want.items():
        if name == "warm":
            continue
        g = np.asarray(got[name])
        assert g.dtype == w.dtype, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif w.size:
            same = (g == w) | (np.isnan(g) & np.isnan(w))  # -inf, NaN too
            with np.errstate(invalid="ignore"):
                err = np.where(same, 0.0, np.abs(g.astype(np.float64) - w))
            scale = max(float(np.max(np.abs(w[np.isfinite(w)]), initial=0.0)), 1.0)
            assert float(np.max(err)) <= 1e-4 * scale, name


def test_printing_matches_jax(capsys):
    """The progress row, the final lines and the timer report (with the
    race's polar reseeds split from the dense-eigh fallbacks) print what
    the JAX package's printing functions print."""
    sc = {"iter": 1000, "status": 0, "gap": 1.5e-3, "feas": 2.5e-4,
          "prim_obj": -12.5, "dual_obj": -12.4, "pres": 3e-3, "dres": 4e-4,
          "comb": 3e-3, "sum_target_rank": 3, "proj_fallbacks": 7,
          "sub_rel_resid": 0.0, "sub_min_theta": 0.0, "sub_npos": 0}
    res = tx.Result(status=1, status_string="Optimal solution found",
                    objval=12.5, dual_objval=12.4, gap=1e-4, iter=598,
                    final_rank=8, time=1.25)
    timers = {"setup": 0.1, "f32 loop": 2.0, "f64 loop": 0.5,
              "host sync": 0.01, "snapshot": 0.0, "finalize": 0.02}
    out = {}
    for name, mod in (("jax", jsolver), ("torch", tsolver)):
        for o in (jx.Options(extended_log=True), jx.Options(log_repeat_header=True)):
            mod._log_progress(sc, 3.25, o)
        mod._log_final(res)
        for fb in ({"f32": 5, "f32_is_polar": True},
                   {"f32": 0, "f32_is_polar": False}):
            print(mod._timer_report(timers, {"f32": 3, "f64": 1}, res, 9, fb))
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"]
