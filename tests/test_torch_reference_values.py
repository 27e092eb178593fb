"""The constants chip_smoke.py holds the port to on the card stay true.

chip_smoke.py solves maxcut_problem(random_graph_weights(0, 250)) on a
CUDA card twice: with Options(hybrid_precision=False) (phase A) and with
the default Options() (phase C, the hybrid race and polish), and compares
each with the JAX package's solve of the same instance.  This test
re-solves both with the JAX package on the CPU -- the default one with
chunk_iters=256, the port's fixed chunk, so that its hand-over points do
not move with the clock -- so a change to the reference cannot leave the
card's constants stale.

The solves run in one child process on one thread (XLA's Eigen pool and
BLAS threads off).  In the test process XLA would use every core; beside
the suite's other multi-threaded XLA tests under xdist the two
oversubscribed the cores and both ran 5-6x slower (on an 8-core host the
f64 solve took ~480 s instead of ~10 s).  On one thread they take ~7 s
and ~11 s there.  The f64 solve gives the same status and iterations with
the objective and the diagonal error equal to 1e-13 relative; the hybrid
solve repeats exactly (its f32 sums depend on the thread count, so the
constants are those of one thread).

A second one-thread child runs the port's side of the instance on the
CPU: its default solve, and the race's f32 and f64 programs stepped beside
the JAX package's from one state (~45 s).  They separate the port's race
logic, which matches the JAX package's step for step in f64, from f32
rounding, which moves the f32 race's accept decisions and so its
hand-over and objective within the solver's tolerance.
"""

import ast
import functools
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = ROOT / "chip_smoke.py"

CHILD = """
import contextlib, io, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
import proxsdp_tpu as jx
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
problem, Xidx = maxcut_problem(random_graph_weights(0, int(sys.argv[1])))
out = {}
for key, opts in (("f64", jx.Options(hybrid_precision=False)),
                  ("hybrid", jx.Options(chunk_iters=256, log_verbose=True,
                                        timer_verbose=True))):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = jx.solve(problem, opts)
    out[key] = {"status": res.status, "status_string": res.status_string,
                "objval": res.objval, "iter": res.iter,
                "diag_err": float(np.max(np.abs(np.diag(res.primal[Xidx]) - 1.0))),
                "log": buf.getvalue()}
print(json.dumps(out))
"""

# The port's side of the same instance on the CPU: its default solve, and
# the race's programs stepped beside the JAX package's from one state -- N0
# polar iterations from init_state, then, from the JAX state seeded with
# the top-k basis as the hybrid driver seeds it, N1 subspace iterations
# with polar reseeds -- in f32 (the race) and in f64 (the same logic with
# rounding out of the way).
PORT_CHILD = """
import contextlib, io, json, sys
sys.path.insert(0, "tests")
import numpy as np, jax.numpy as jnp, torch
import _torch_parity as tp
import proxsdp_tpu as jx, proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu_torch import convert, solver as tsolver
from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
side, N0, N1 = map(int, sys.argv[1:4])
problem, Xidx = maxcut_problem(random_graph_weights(0, side))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    res = tx.solve(problem, tx.Options(chunk_iters=256, log_verbose=True,
                                       timer_verbose=True), device="cpu")
out = {"solve": {"status": res.status, "objval": res.objval, "iter": res.iter,
                 "log": buf.getvalue()}}
setup = tp.jax_setup(f"maxcut{side}")
layout = setup.layout

def jstate(h):
    return jsolver.State(**{k: (tuple(jnp.asarray(w) for w in v) if k == "warm"
                                else jnp.asarray(v)) for k, v in h.items()})

def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(a).max())

for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                       ("float64", jnp.float64, torch.float64)):
    kw = dict(dtype=name, hybrid_precision=False, projection="polar",
              subspace_fallback="polar", subspace_mixed=False)
    o_j = tp.jax_operands(setup, jdt)
    o_t = tp.torch_operands_from_jax(o_j, setup, tdt)
    host = tp.jax_state_numpy(jsolver.init_state(layout, jx.Options(**kw), setup))
    s_j, s_t = jstate(host), convert.state_from_numpy(host, tp.DEV)
    it_j = tp.jax_iteration(layout, jx.Options(**kw))
    it_t = tsolver.make_chunk_runner(layout, tx.Options(**kw), device=tp.DEV)[1]
    polar = []
    for k in range(N0):
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t, k)
        if k >= 1:  # iteration 1 projects a rounding-level matrix
            polar.append(rel(s_j.x, s_t.x.numpy()))
    k_sub, r_obs, specs = jsolver._estimate_subspace(s_j, layout,
                                                     jx.Options(**kw), setup.c)
    host = tp.jax_state_numpy(jsolver._seed_subspace_warm(s_j, specs, k_sub, jdt))
    s_j, s_t = jstate(host), convert.state_from_numpy(host, tp.DEV)
    it_j = tp.jax_iteration(layout, jx.Options(**kw, subspace_rank=k_sub))
    it_t = tsolver.make_chunk_runner(
        layout, tx.Options(**kw, subspace_rank=k_sub), device=tp.DEV)[1]
    fb_j, fb_t, sub = [], [], []
    for k in range(N1):
        p_j, p_t = int(s_j.proj_fallbacks), int(s_t.proj_fallbacks)
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t, N0 + k)
        fb_j.append(int(s_j.proj_fallbacks) - p_j)
        fb_t.append(int(s_t.proj_fallbacks) - p_t)
        sub.append(rel(s_j.x, s_t.x.numpy()))
    differ = [N0 + 1 + k for k in range(N1) if fb_j[k] != fb_t[k]]
    out[name] = {"polar_x_rel": polar, "k_sub": k_sub, "r_obs": r_obs,
                 "sub_x_rel": sub, "reseeds": [sum(fb_j), sum(fb_t)],
                 "first_differing_decision": differ[0] if differ else None,
                 "differing_decisions": len(differ)}
print(json.dumps(out))
"""
# polar iterations before the race's subspace entry (the hybrid driver
# enters at 256 under chunk_iters=256) and the subspace iterations after
# it up to the reference's hand-over at 597
RACE_POLAR_ITERS, RACE_SUB_ITERS = 256, 341

ONE_THREAD = {
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
    "OPENBLAS_NUM_THREADS": "1",
    "OMP_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
}


def _constants() -> dict:
    tree = ast.parse(SMOKE.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name == "SIDE" or (name or "").startswith(("REF_", "HYB_REF_")):
                out[name] = ast.literal_eval(node.value)
    return out


@functools.lru_cache(maxsize=1)
def _reference(side: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(side)],
        cwd=ROOT, env={**os.environ, **ONE_THREAD},
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=1)
def _port(side: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", PORT_CHILD, str(side), str(RACE_POLAR_ITERS),
         str(RACE_SUB_ITERS)],
        cwd=ROOT, env={**os.environ, **ONE_THREAD},
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_side250_reference_values():
    k = _constants()
    assert k["SIDE"] == 250
    res = _reference(k["SIDE"])["f64"]
    assert res["status"] == 1, res["status_string"]
    assert abs(res["objval"] - k["REF_OBJ"]) <= 1e-6 * abs(k["REF_OBJ"])
    assert abs(res["iter"] - k["REF_ITERS"]) <= 2
    assert abs(res["diag_err"] - k["REF_DIAG_ERR"]) <= 1e-6 * k["REF_DIAG_ERR"]


def test_side250_hybrid_reference_values():
    """The default path's constants: objective, iterations, the race's
    subspace rank, the hand-over iteration, the polish rank, the polar
    reseeds and dense-eigh fallbacks, the diagonal error."""
    k = _constants()
    res = _reference(k["SIDE"])["hybrid"]
    log = res["log"]
    assert res["status"] == 1, res["status_string"]
    assert abs(res["objval"] - k["HYB_REF_OBJ"]) <= 1e-9 * abs(k["HYB_REF_OBJ"])
    assert res["iter"] == k["HYB_REF_ITERS"]
    race = re.search(r"f32 race: subspace rank (\d+)", log)
    hand = re.search(r"f32 -> f64 at iter (\d+)", log)
    pol = re.search(r"f64 polish: subspace rank (\d+)", log)
    fb = re.search(r"f32 polar-reseed=(\d+), dense-eigh=(\d+)", log)
    assert int(race.group(1)) == k["HYB_REF_RACE_RANK"]
    assert int(hand.group(1)) == k["HYB_REF_HANDOVER"]
    assert int(pol.group(1)) == k["HYB_REF_POLISH_RANK"]
    assert int(fb.group(1)) == k["HYB_REF_RESEEDS"]
    assert int(fb.group(2)) == k["HYB_REF_DENSE"]
    assert abs(res["diag_err"] - k["HYB_REF_DIAG_ERR"]) <= 1e-9 * k["HYB_REF_DIAG_ERR"]


def test_side250_port_cpu_solve():
    """The port's default solve of the same instance on the CPU (plain
    versions, one thread) against the constants at the tolerances of
    test_torch_hybrid.py: status, |obj difference| <= 1e-4 * (1 + |obj|),
    |iteration difference| <= max(5, 5 %), the race and polish ranks, the
    hand-over within 5 iterations.  Observed when written: 596 iterations,
    objective 1250.5722470970602 (difference -0.0236), hand-over at 595,
    141 polar reseeds (the reference: 598, 597, 143)."""
    k = _constants()
    res = _port(k["SIDE"])["solve"]
    log = res["log"]
    assert res["status"] == 1
    assert abs(res["objval"] - k["HYB_REF_OBJ"]) <= 1e-4 * (1 + abs(k["HYB_REF_OBJ"]))
    assert abs(res["iter"] - k["HYB_REF_ITERS"]) <= max(5, 0.05 * k["HYB_REF_ITERS"])
    race = re.search(r"f32 race: subspace rank (\d+)", log)
    hand = re.search(r"f32 -> f64 at iter (\d+)", log)
    pol = re.search(r"f64 polish: subspace rank (\d+)", log)
    assert int(race.group(1)) == k["HYB_REF_RACE_RANK"]
    assert abs(int(hand.group(1)) - k["HYB_REF_HANDOVER"]) <= 5
    assert int(pol.group(1)) == k["HYB_REF_POLISH_RANK"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_side250_race_steps_match_jax(dtype):
    """The race's programs stepped beside the JAX package's from one state
    (PORT_CHILD): the polar phase, the subspace entry (rank 24, observed
    14), then the subspace steps with polar reseeds up to the reference's
    hand-over.  In f64 the two take the same accept/reseed decision at
    every step and their x agree to rounding: the port's race logic is the
    JAX package's.  In f32 they agree to 5.5e-6 relative through the polar
    phase; the first polar reseeds (Newton-Schulz, accurate to ~1e-5 of
    the matrix) lift the difference to ~5e-4, and from the 42nd subspace
    step (iteration 298) the accept decisions part (JAX 138 reseeds, port
    142, in this stepping).  Observed when written: f64 polar <= 7.9e-15,
    subspace <= 6.9e-9, 149 reseeds each."""
    k = _constants()
    d = _port(k["SIDE"])[dtype]
    assert (d["k_sub"], d["r_obs"]) == (k["HYB_REF_RACE_RANK"], 14)
    if dtype == "float64":
        assert max(d["polar_x_rel"]) <= 1e-12
        assert d["differing_decisions"] == 0
        assert d["reseeds"][0] == d["reseeds"][1] > 0
        assert max(d["sub_x_rel"]) <= 1e-7
    else:
        assert max(d["polar_x_rel"]) <= 2e-5
        first = d["first_differing_decision"] or RACE_POLAR_ITERS + RACE_SUB_ITERS + 1
        assert first > RACE_POLAR_ITERS + 25
        assert max(d["sub_x_rel"][: first - RACE_POLAR_ITERS - 1]) <= 2e-3
        assert abs(d["reseeds"][0] - d["reseeds"][1]) <= 0.05 * d["reseeds"][0]
