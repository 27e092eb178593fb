"""The port's batch driver (``proxsdp_tpu_torch.parallel.batch``) on the CPU
against the JAX package's (``proxsdp_tpu.parallel.batch``).

B = 8 max-cut instances of side 10, as tests/test_parallel.py solves them:
the f64 program stepped from one stacked init_state, whole solves in f64
and under the default hybrid Options(), the iteration limit, the geometry
check and every option outside the slice.  A one-thread child process
keeps chip_smoke.py's phase-D reference objectives true.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity as tp
import jax.numpy as jnp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu.parallel import batch as jbatch
from proxsdp_tpu.problem import preprocess as jpreprocess
from proxsdp_tpu_torch import convert
from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
from proxsdp_tpu_torch.parallel import batch as tbatch
from proxsdp_tpu_torch.problem import preprocess

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, SIDE = 8, 10


def _problems(pkg, B=B, side=SIDE):
    mod = tp.jmaxcut if pkg is jx else tp.tmaxcut
    return [mod.maxcut_problem(mod.random_graph_weights(s, side))[0]
            for s in range(B)]


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def test_iterates_match_jax():
    """60 iterations of the f64 program from one stacked init_state: every
    field within 1e-10 relative, iterations and statuses equal."""
    opts_j = jbatch._force_batch_options(jx.Options(hybrid_precision=False))
    opts_t = tbatch._force_batch_options(tx.Options(hybrid_precision=False))
    setups_j = [jpreprocess(p) for p in _problems(jx)]
    layout = setups_j[0].layout
    ops_j, kind = jbatch._batch_operands(setups_j, jnp.float64)
    states_j = jbatch._stack_states(
        [jbatch.init_state(layout, opts_j, s) for s in setups_j])
    host = tp.jax_state_numpy(states_j)
    run_j, _ = jbatch._cached_batch_runner(layout, opts_j, kind)
    want = tp.jax_state_numpy(run_j(
        states_j, ops_j._replace(chunk_end=jnp.asarray(60, jnp.int32))))

    setups_t = [preprocess(p) for p in _problems(tx)]
    ops_t = tbatch._batch_operands(setups_t, torch.float64, tp.DEV, "auto")
    run_t = tbatch.make_batch_runner(setups_t[0].layout, opts_t, device=tp.DEV)[0]
    got = convert.state_to_numpy(run_t(convert.state_from_numpy(host, tp.DEV),
                                       ops_t, 60))
    np.testing.assert_array_equal(got["iter"], np.full(B, 60))
    for name in want:
        if name == "warm":  # an eigenvector: compared up to sign
            g, w = got[name][0], want[name][0]
            np.testing.assert_allclose(np.abs(np.sum(g * w, axis=1)), 1.0,
                                       rtol=0, atol=1e-9)
            continue
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12,
                                       err_msg=name)


def test_state_round_trip():
    """A batched JAX state (axis 0 = instance) goes to the port and back
    unchanged, and splits into its instances."""
    opts = jx.Options()
    setups = [jpreprocess(p) for p in _problems(jx, B=3)]
    states = jbatch._stack_states(
        [jbatch.init_state(setups[0].layout, opts, s) for s in setups])
    host = tp.jax_state_numpy(states)
    back = convert.state_to_numpy(convert.state_from_numpy(host, tp.DEV))
    for name, v in host.items():
        for g, w in zip(back[name] if name == "warm" else [back[name]],
                        v if name == "warm" else [v]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    one = convert.index_state(back, 2)
    single = tp.jax_state_numpy(jbatch._index_state(states, 2))
    for name in single:
        if name != "warm":
            np.testing.assert_array_equal(one[name], single[name])


@pytest.fixture(scope="module")
def f64_results():
    opts = dict(hybrid_precision=False)
    return (jbatch.solve_batch(_problems(jx), jx.Options(**opts)),
            tx.solve_batch(_problems(tx), tx.Options(**opts), device="cpu"))


def test_f64_solve_matches_jax(f64_results):
    want, got = f64_results
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert g.iter == w.iter
        assert _rel(g.objval, w.objval) <= 1e-9
        np.testing.assert_allclose(g.primal, w.primal, rtol=0, atol=1e-8)


def test_hybrid_solve_matches_jax():
    """Default Options(): the f32 race, hand-over and f64 phase.  Statuses
    equal, objectives within the tolerance, iterations within 25 % (f32
    rounding moves the race's stall decisions, ROADMAP C9)."""
    want = jbatch.solve_batch(_problems(jx), jx.Options())
    stats = tbatch.BatchStats()
    got = tx.solve_batch(_problems(tx), tx.Options(), device="cpu", stats=stats)
    assert 0 < stats.race_iters <= max(r.iter for r in got)
    assert stats.steps >= max(r.iter for r in got)
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert _rel(g.objval, w.objval) <= 1e-4
        assert abs(g.iter - w.iter) <= 0.25 * w.iter


def test_iteration_limit_statuses():
    got = tx.solve_batch(_problems(tx, B=2), tx.Options(max_iter=3),
                         device="cpu")
    want = jbatch.solve_batch(_problems(jx, B=2), jx.Options(max_iter=3))
    assert [r.status for r in got] == [r.status for r in want] == [3, 3]
    assert [r.iter for r in got] == [r.iter for r in want]
    assert all(r.iter <= 3 for r in got)


def test_mixed_geometry_rejected():
    other = maxcut_problem(random_graph_weights(0, 11))[0]
    with pytest.raises(ValueError, match="geometry"):
        tx.solve_batch([_problems(tx, B=1)[0], other], device="cpu")


def test_declaration_returned_without_certificate_search():
    """A 5/6 declaration (here forced early by max_obj) is returned with
    certificate_search=False, as the JAX driver returns it."""
    kw = dict(max_obj=1.0, min_iter_max_obj=5, hybrid_precision=False,
              certificate_search=False)
    got = tx.solve_batch(_problems(tx, B=2), tx.Options(**kw), device="cpu")
    want = jbatch.solve_batch(_problems(jx, B=2), jx.Options(**kw))
    assert [r.status for r in got] == [r.status for r in want]
    assert {r.status for r in got} <= {5, 6}


def _scaled_rows():
    """Max-cut at side 10 with the diagonal constraints scaled by 2: the
    geometry of the others, another constraint matrix."""
    W = random_graph_weights(0, SIDE)
    opt = tx.Optimizer()
    X = opt.add_psd_var(SIDE)
    for i in range(SIDE):
        opt.add_eq_constraint({int(X[i, i]): 2.0}, 2.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * W), sense="max")
    return opt.build_problem()


@pytest.mark.parametrize("case, item", [
    ("mesh", "B14"), ("tp_shards", "A12")])
def test_out_of_slice_raises(case, item):
    """Every mode outside the slice raises, naming its ROADMAP item.  (The
    polar projection and the equilibration options, which raised A11 and
    A6, run since they were ported: tests/test_torch_batch_large.py; the
    COO operator, SOC blocks and any layout of blocks too:
    tests/test_torch_batch_layouts.py; checkpoint_path, A10:
    tests/test_torch_checkpoint.py.)"""
    problems, kw = _problems(tx, B=2), {}
    if case == "mesh":
        kw["mesh"] = object()
    elif case == "tp_shards":
        kw["options"] = tx.Options(tp_shards=2)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tx.solve_batch(problems, device="cpu", **kw)


def test_per_instance_operators_solve():
    """Instances with different constraint matrices, which raised "A11"
    before they were ported, solve: the scaled rows share the max-cut's
    pattern ("ell_batched"), and both instances reach status 1 at the
    single solves' objectives."""
    problems = [_problems(tx, B=1)[0], _scaled_rows()]
    setups = [preprocess(p) for p in problems]
    o = tbatch._batch_operands(setups, torch.float64, tp.DEV, "auto")
    assert tbatch.operator_kind(o.M) == "ell_batched"
    opts = tx.Options(hybrid_precision=False)
    res = tx.solve_batch(problems, opts, device="cpu")
    for r, p in zip(res, problems):
        single = tx.solve(p, opts, device="cpu")
        assert r.status == single.status == 1
        assert _rel(r.objval, single.objval) <= 1e-4


def test_solve_batch_requires_device(monkeypatch):
    """solve_batch() runs on the card by default; where there is none it
    raises and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx.solve_batch(_problems(tx, B=2))


# chip_smoke.py phase D's references, from a one-thread child process (as
# test_torch_reference_values.py runs its reference; the f32 race's sums
# depend on XLA's thread count): the JAX package's batch solves of
# side-16 instances 0-15 under phase D's Options() and with
# hybrid_precision=False.  Each instance of phase D's 1024 reaches an f32
# status inside the race's one 1024-iteration chunk, freezes there, and
# runs alone after the hand-over, so its result does not depend on the
# rest of the batch: the batch of 16 gives instances 0-15 of the batch of
# 1024 bit for bit (checked once on the CPU; the 1024 take ~45 s)
REF_CHILD = """
import json, jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import proxsdp_tpu as jx
from proxsdp_tpu.parallel.batch import solve_batch
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
probs = [maxcut_problem(random_graph_weights(s, 16))[0] for s in range(16)]
kw = dict(tol_gap=1e-4, tol_feasibility=1e-4)
out = {}
for key, opts in (("f64", jx.Options(hybrid_precision=False, **kw)),
                  ("hybrid", jx.Options(**kw))):
    res = solve_batch(probs, opts)
    out[key] = {"objval": [r.objval for r in res],
                "iter": [r.iter for r in res],
                "status": sorted({r.status for r in res})}
print(json.dumps(out))
"""
ONE_THREAD = {"JAX_PLATFORMS": "cpu",
              "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
              "OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1",
              "MKL_NUM_THREADS": "1"}


def _smoke_constants() -> dict:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    return {node.targets[0].id: ast.literal_eval(node.value)
            for node in tree.body
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and getattr(node.targets[0], "id", "").startswith("BATCH_")}


def test_phase_d_reference_values():
    """chip_smoke.py's phase-D constants are the JAX package's batch
    solves (1e-9 relative), and the port's CPU f64 solve of instances
    0-15 repeats the JAX f64 one iteration for iteration."""
    proc = subprocess.run([sys.executable, "-c", REF_CHILD], cwd=ROOT,
                          env={**os.environ, **ONE_THREAD},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    c = _smoke_constants()
    assert (c["BATCH_SIDE"], c["BATCH_SIZE"]) == (16, 1024)
    for key, name in (("f64", "BATCH_REF_OBJ"), ("hybrid", "BATCH_HYB_REF_OBJ")):
        assert ref[key]["status"] == [1]
        assert len(c[name]) == 16
        for got, want in zip(c[name], ref[key]["objval"]):
            assert _rel(got, want) <= 1e-9, (name, got, want)
    res = tx.solve_batch(
        [maxcut_problem(random_graph_weights(s, 16))[0] for s in range(16)],
        tx.Options(tol_gap=1e-4, tol_feasibility=1e-4, hybrid_precision=False),
        device="cpu")
    assert [r.iter for r in res] == ref["f64"]["iter"]
    for r, want in zip(res, ref["f64"]["objval"]):
        assert r.status == 1 and _rel(r.objval, want) <= 1e-9
