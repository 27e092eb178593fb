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

import numpy as np
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
# The JAX package's side of the giant-side constants (chip_smoke.py phases
# E and F, and their side-150 analogues in tests/test_torch_lanczos.py):
# its default Options(chunk_iters=256) solve of the instance, and N
# iterations of its f64 Lanczos program (Options(hybrid_precision=False))
# from init_state, stepped one at a time, recording per iteration whether
# the residual test accepted (no polar fallback) and the largest ratio of
# a leading pair's residual to its threshold (replayed with lanczos_topk on
# the iteration's input).  Iteration 1 projects x0 - tau c, 0 in exact
# arithmetic; XLA's fused evaluation leaves ~1e-21 of noise there, whose
# top Ritz vector becomes the JAX warm start.  The port computes the exact
# 0, and its start vector comes back as the top Ritz vector; the stepping
# sets the JAX warm vector after iteration 1 to that exact answer, so the
# two runs can be compared from there.  Arguments: side, N,
# full_eig_max_side, what ("solve", "steps" or both).
JAX_LZ_CHILD = """
import contextlib, io, json, sys, time
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
sys.path[:0] = [".", "tests"]
import _torch_parity as tp
import proxsdp_tpu as jx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.ops import lanczos as jlz
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
side, N, fems, what = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
kw = {"full_eig_max_side": fems}
problem, Xidx = maxcut_problem(random_graph_weights(0, side))
out = {}
if "solve" in what:
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        res = jx.solve(problem, jx.Options(chunk_iters=256, log_verbose=True,
                                           timer_verbose=True, **kw))
    X = res.primal[Xidx]
    out["solve"] = {"status": res.status, "objval": res.objval,
                    "iter": res.iter, "final_rank": res.final_rank,
                    "diag_err": float(np.max(np.abs(np.diag(X) - 1.0))),
                    "seconds": time.time() - t0, "log": buf.getvalue()}
if "steps" in what:
    t0 = time.time()
    setup = tp.jax_setup(f"maxcut{side}")
    layout = setup.layout
    opts = jx.Options(hybrid_precision=False, **kw)
    o = tp.jax_operands(setup)
    s = jsolver.init_state(layout, opts, setup)
    w0 = np.asarray(s.warm[0])
    _, it, fetch = jsolver.make_chunk_runner(layout, opts)
    it, fetch = jax.jit(it), fetch
    ncv = min(max(2 * opts.max_target_rank_krylov_eigs + 1,
                  opts.eigsolver_min_lanczos, side // 32), side)
    tol = opts.krylovkit_tol

    @jax.jit
    def margin(s, o, tr):
        X = (s.x - s.primal_step * (s.Mty + o.c)).reshape(side, side)
        X = 0.5 * (X + X.T)
        r = jlz.lanczos_topk(X, s.warm[0], ncv=ncv, tol=tol)
        thr = jnp.maximum(tol * jnp.abs(r.vals), 10 * tol)
        return jnp.max(jnp.where(jnp.arange(ncv) < tr, r.resid / thr, -jnp.inf))

    accept, ratios, replay_differs = [], [], []
    for k in range(N):
        tr = int(s.target_rank[0])
        ratio = float(margin(s, o, tr))
        fb = int(s.proj_fallbacks)
        s = it(s, o)
        if k == 0:
            s = s._replace(warm=(jnp.asarray(w0 / np.sqrt(np.sum(w0 * w0))),))
        accept.append(int(s.proj_fallbacks) == fb)
        ratios.append(ratio)
        if accept[-1] != (ratio <= 1.0):
            replay_differs.append(k + 1)
    out["steps"] = {"N": N, "ncv": ncv,
                    "accept": "".join("1" if a else "0" for a in accept),
                    "ratios": ratios, "replay_differs": replay_differs,
                    "fetch": np.asarray(fetch(s)).tolist(),
                    "seconds": time.time() - t0}
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


# ------------------------------------------------ sides above 1024 (Lanczos)

LANCZOS_TESTS = ROOT / "tests" / "test_torch_lanczos.py"


def _module_constants(path, prefixes) -> dict:
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if (name or "").startswith(prefixes):
                out[name] = ast.literal_eval(node.value)
    return out


def _jax_lz(side: int, n_steps: int, fems: int, what: str, env: dict,
            timeout: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", JAX_LZ_CHILD, str(side), str(n_steps),
         str(fems), what],
        cwd=ROOT, env={**os.environ, **env}, capture_output=True, text=True,
        timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _events(log: str) -> tuple:
    race = re.search(r"f32 race: subspace rank (\d+)", log)
    hand = re.search(r"f32 -> f64 at iter (\d+)", log)
    pol = re.search(r"f64 polish: subspace rank (\d+)", log)
    fb = re.search(r"f32 polar-reseed=(\d+)", log)
    return tuple(int(m.group(1)) for m in (race, hand, pol, fb))


def test_lanczos_constants_are_consistent():
    """chip_smoke.py's phase E and F constants hang together: the accept
    sequence has LZF_ITERS entries and its rejections are the last
    iterate's proj_fallbacks; the near-threshold iterations lie in range
    and within 1e-2 of the threshold."""
    k = _module_constants(SMOKE, ("LZ_", "LZE_", "LZF_"))
    assert k["LZ_SIDE"] == 2000 and k["LZF_ITERS"] == 300
    acc, fetch = k["LZF_REF_ACCEPT"], k["LZF_REF_FETCH"]
    assert len(acc) == k["LZF_ITERS"] and set(acc) <= {"0", "1"}
    assert fetch[0] == k["LZF_ITERS"] and fetch[1] == 0
    assert acc.count("0") == fetch[10]
    assert all(1 <= t <= k["LZF_ITERS"] and abs(r - 1.0) <= 1e-2
               for t, r in k["LZF_REF_NEAR"].items())
    assert k["LZE_REF_ITERS"] > k["LZE_REF_HANDOVER"] > 0
    assert k["LZE_REF_RACE_RANK"] in (16, 24, 32, 48, 64, 96, 128, 192, 256)


def test_lanczos_reference_values_side150():
    """The side-150 analogues of phases E and F (tests/test_torch_lanczos.py
    holds the port to them) re-derived in a one-thread JAX child (~30 s):
    the default solve's objective to 1e-9 relative, its iterations and
    events exactly; the 400-iteration f64 Lanczos program's last iterate to
    1e-12 relative, its target rank and fallbacks exactly, and every
    iteration's recorded accept decision equal to the replayed test's."""
    k = _module_constants(LANCZOS_TESTS, ("SIDE150_",))
    out = _jax_lz(150, k["SIDE150_STEPS"], 120, "solve,steps", ONE_THREAD, 600)
    res, steps = out["solve"], out["steps"]
    assert res["status"] == 1
    assert abs(res["objval"] - k["SIDE150_OBJ"]) <= 1e-9 * abs(k["SIDE150_OBJ"])
    assert res["iter"] == k["SIDE150_ITERS"]
    assert _events(res["log"]) == (k["SIDE150_RACE_RANK"], k["SIDE150_HANDOVER"],
                                   k["SIDE150_POLISH_RANK"], k["SIDE150_RESEEDS"])
    got, want = steps["fetch"], k["SIDE150_FETCH"]
    assert got[:2] == want[:2] and got[9:11] == want[9:11]
    for g, w in zip(got[2:9], want[2:9]):
        assert abs(g - w) <= 1e-12 * abs(w)
    assert steps["replay_differs"] == []


@pytest.mark.slow
def test_side2000_reference_values():
    """chip_smoke.py's phase E and F constants re-derived with all of the
    host's threads (~20 minutes on 8 cores; the JAX f64 Lanczos program
    takes ~2 s an iteration there).  The f64 stepping repeats exactly; the
    default solve's f32 race sums depend on the thread count, so it repeats
    to 1e-9 only on an 8-core host and is held to phase E's like-mode
    bound, 2e-4 (1 + |obj|), elsewhere."""
    k = _module_constants(SMOKE, ("LZ_", "LZE_", "LZF_"))
    out = _jax_lz(k["LZ_SIDE"], k["LZF_ITERS"], 1024, "solve,steps",
                  {"JAX_PLATFORMS": "cpu"}, 3600)
    res, steps = out["solve"], out["steps"]
    assert steps["accept"] == k["LZF_REF_ACCEPT"]
    assert steps["fetch"][:2] == k["LZF_REF_FETCH"][:2]
    assert steps["fetch"][9:11] == k["LZF_REF_FETCH"][9:11]
    for g, w in zip(steps["fetch"][2:9], k["LZF_REF_FETCH"][2:9]):
        assert abs(g - w) <= 1e-12 * abs(w)
    near = {t + 1: r for t, r in enumerate(steps["ratios"]) if abs(r - 1) <= 1e-2}
    assert near.keys() == k["LZF_REF_NEAR"].keys()
    assert steps["replay_differs"] == []
    assert res["status"] == 1
    obj = k["LZE_REF_OBJ"]
    if os.cpu_count() == 8:
        assert abs(res["objval"] - obj) <= 1e-9 * abs(obj)
        assert res["iter"] == k["LZE_REF_ITERS"]
        assert _events(res["log"]) == (k["LZE_REF_RACE_RANK"], k["LZE_REF_HANDOVER"],
                                       k["LZE_REF_POLISH_RANK"], k["LZE_REF_RESEEDS"])
    else:
        assert abs(res["objval"] - obj) <= 2e-4 * (1 + abs(obj))


# chip_smoke.py's phase G references: the JAX package's batch solve of the
# max-cut sweep under phase G's Options(), with its host reseeds and
# programs logged, lined up with the port where the JAX driver has two
# faults the port does not copy -- after iteration 1 its first subspace
# program takes the basis the port's iteration 1 computes on X = 0
# (cholqr2 of the start basis, columns reversed: ROADMAP C11), and its
# fetch reads each instance's latest ring slot (C12) -- then its f64
# dense-eigh solve at 1e-8 tolerances (the optima).
G_CHILD = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
import proxsdp_tpu as jx
from proxsdp_tpu.parallel import batch as jb
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
from proxsdp_tpu_torch import kernels
B, side = int(sys.argv[1]), int(sys.argv[2])
reseeds, programs, patched = [], [], []
reseed, runner = jb._reseed_batch, jb._cached_batch_runner
def logged_reseed(states, layout, k, mask, c_np, opts):
    it = np.asarray(states.iter)
    out, r = reseed(states, layout, k, mask, c_np, opts)
    reseeds.append([str(np.asarray(states.x).dtype), int(it.min()),
                    int(it.max()), int(k), int(np.sum(mask)), int(r)])
    return out, r
def fetch_latest(ss):
    i = (ss.iter - 1) % ss.buf_gap.shape[1]
    take = jax.vmap(lambda buf, j: buf[j])
    ft = ss.buf_gap.dtype
    return jnp.stack([ss.iter.astype(ft), ss.status.astype(ft),
                      take(ss.buf_gap, i), take(ss.buf_feas, i),
                      take(ss.buf_prim_obj, i), take(ss.buf_dual_obj, i),
                      ss.sub_worst.astype(ft)], axis=-1)
def logged_runner(layout, opts, m_kind="shared"):
    programs.append([opts.dtype, int(opts.subspace_rank)])
    run, _ = runner(layout, opts, m_kind)
    def run_patched(states, ops):
        if not patched and states.warm[0].ndim == 3:
            patched.append(True)
            V = torch.tensor(np.asarray(states.warm[0]))
            states = run(states,
                         ops._replace(chunk_end=jnp.asarray(1, jnp.int32)))
            eps = kernels.CHOLQR_EPS[V.dtype]
            Q = kernels._cholqr_batch_plain(
                kernels._cholqr_batch_plain(V, eps), eps)
            states = states._replace(warm=(jnp.asarray(Q.flip(-1).numpy()),))
        return run(states, ops)
    return run_patched, jax.jit(fetch_latest)
jb._reseed_batch, jb._cached_batch_runner = logged_reseed, logged_runner
probs = [maxcut_problem(random_graph_weights(s, side))[0] for s in range(B)]
res = jb.solve_batch(probs, jx.Options(tol_gap=1e-4, tol_feasibility=1e-4))
jb._reseed_batch, jb._cached_batch_runner = reseed, runner
exact = jb.solve_batch(probs, jx.Options(hybrid_precision=False, tol_gap=1e-8,
                                         tol_feasibility=1e-8),
                       projection="eigh")
it = np.array([r.iter for r in res])
print(json.dumps({
    "obj": [r.objval for r in res], "exact": [r.objval for r in exact],
    "status": sorted({r.status for r in res} | {r.status for r in exact}),
    "iters": f"{it.min()}/{int(np.median(it))}/{it.max()}",
    "reseeds": reseeds, "programs": programs}))
"""


def _g_constants(tag: str) -> dict:
    return _module_constants(SMOKE, tuple(f"{tag}_{n}" for n in (
        "SIZE", "SIDE", "REF_OBJ", "EXACT_OBJ", "REF_ITERS", "REF_RESEEDS",
        "REF_PROGRAMS")))


@pytest.mark.parametrize("tag", ["G1", "G2"])
def test_phase_g_constants_are_consistent(tag):
    """chip_smoke.py's phase G constants hang together: one objective and
    one optimum per instance, each answer within 5e-3 (1 + |opt|) of its
    optimum; the reseed history starts with every instance at iteration
    128 on bucket 16, the programs start with the f32 subspace program at
    16 and end with the f64 eigh program (the drop in the race)."""
    k = _g_constants(tag)
    B = k[f"{tag}_SIZE"]
    obj, exact = k[f"{tag}_REF_OBJ"], k[f"{tag}_EXACT_OBJ"]
    assert len(obj) == len(exact) == B
    assert all(abs(o - e) <= 5e-3 * (1 + abs(e)) for o, e in zip(obj, exact))
    res, prg = k[f"{tag}_REF_RESEEDS"], k[f"{tag}_REF_PROGRAMS"]
    assert res[0] == ("float32", 128, 128, 16, B, res[0][5])
    assert all(len(r) == 6 and 0 < r[4] <= B for r in res)
    assert prg[0] == ("float32", 16) and prg[-1] == ("float64", 0)


@pytest.mark.slow
@pytest.mark.parametrize("tag", ["G1", "G2"])
def test_phase_g_reference_values(tag):
    """chip_smoke.py's phase G constants re-derived by the JAX package in a
    child on XLA's default threads (~3 minutes for G1, ~8 for G2 on 8
    cores): the batch solve's objectives to 1e-9 relative, its iterations,
    reseeds and programs exactly, the optima to 1e-9.  The constants were
    derived on 8 cores; XLA splits its f32 sums by the thread count, and on
    one thread G2 takes another program sequence (PERF.md)."""
    k = _g_constants(tag)
    proc = subprocess.run(
        [sys.executable, "-c", G_CHILD, str(k[f"{tag}_SIZE"]),
         str(k[f"{tag}_SIDE"])], cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["status"] == [1]
    for key, name in (("obj", "REF_OBJ"), ("exact", "EXACT_OBJ")):
        for got, want in zip(out[key], k[f"{tag}_{name}"], strict=True):
            assert abs(got - want) <= 1e-9 * (1 + abs(want)), (key, got, want)
    assert out["iters"] == k[f"{tag}_REF_ITERS"]
    assert [tuple(r) for r in out["reseeds"]] == k[f"{tag}_REF_RESEEDS"]
    assert [tuple(p) for p in out["programs"]] == k[f"{tag}_REF_PROGRAMS"]


# chip_smoke.py's phases H and I: the Lovasz-theta SDP at SDPLIB theta6's
# shape through the JAX package's default solve (its block-equilibration
# probe, each arm's round capped at 20 s, then the winner's solve), and
# the seeded conic program with every block kind -- its default solve and
# I_ITERS iterations of its f64 program from init_state.  The generators
# are chip_smoke.py's own (NumPy only), the problems built through the JAX
# package's Optimizer.
HI_CHILD = """
import contextlib, io, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, ".")
import chip_smoke as cs
import proxsdp_tpu as jx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.ops.linop import build_linop
from proxsdp_tpu.problem import preprocess, to_square_form
out = {}
for what in sys.argv[1].split(","):
    if what in ("H", "H2"):
        problem, X = cs.build_theta(jx, cs.theta_graph())
        kw = ({} if what == "H" else
              {"block_equilibration_probe_iters": cs.H2_PROBE_ITERS})
        for beq in (False, True):  # compile both arms' programs first
            jx.solve(problem, jx.Options(chunk_iters=256, max_iter=1,
                                         block_equilibration=beq))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = jx.solve(problem, jx.Options(chunk_iters=256, log_verbose=True,
                                               log_freq=10**9, **kw))
        out[what] = {"status": res.status, "objval": res.objval,
                     "iter": res.iter, "log": buf.getvalue()}
        continue
    if what == "Heq":  # the equilibrated arm's extremes (chip_smoke.py)
        problem, X = cs.build_theta(jx, cs.theta_graph())
        opts = jx.Options(chunk_iters=256, block_equilibration=True)
        cold = jx.solve(problem, opts)
        arm = jx.solve(problem, opts.replace(
            max_iter=3000, time_limit=600, certificate_search=False,
            log_verbose=False, timer_verbose=False, warn_on_limit=False,
            checkpoint_path=""))
        warm = jx.solve(problem, opts, warm_start=arm)
        out[what] = {"status": [cold.status, arm.status, warm.status],
                     "objval": [cold.objval, warm.objval]}
        continue
    if what == "Hopt":
        problem, X = cs.build_theta(jx, cs.theta_graph())
        res = jx.solve(problem, jx.Options(
            chunk_iters=256, tol_gap=1e-7, tol_feasibility=1e-7,
            block_equilibration=True, time_limit=3000, max_iter=200000))
        out[what] = {"status": res.status, "objval": res.objval}
        continue
    data = cs.conic_program_data()
    problem = cs.build_conic_program(jx, data)[0]
    if what == "Isolve":
        res = jx.solve(problem, jx.Options(chunk_iters=256))
        out[what] = {"status": res.status, "objval": res.objval,
                     "iter": res.iter}
        continue
    opts = jx.Options(hybrid_precision=False, block_equilibration=False,
                      max_iter=cs.I_ITERS)
    setup = to_square_form(preprocess(problem))
    layout = setup.layout
    o = jsolver.Operands(
        M=build_linop(setup.A, setup.G, jnp.float64), b=jnp.asarray(setup.b),
        h=jnp.asarray(setup.h), c=jnp.asarray(setup.c),
        norm_b=jnp.asarray(setup.norm_b), norm_h=jnp.asarray(setup.norm_h),
        norm_c=jnp.asarray(setup.norm_c), chunk_end=jnp.asarray(0, jnp.int32),
        obj_scale=jnp.asarray(setup.obj_scale * setup.rhs_scale))
    _, it, fetch = jsolver.make_chunk_runner(layout, opts)
    it = jax.jit(it)
    s = jax.tree_util.tree_map(jnp.asarray, jsolver.init_state(layout, opts, setup))
    for _ in range(cs.I_ITERS):
        s = it(s, o)
    x = np.asarray(s.x)
    norms, lmins = [], []
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        B = x[off : off + side * side].reshape(side, side)
        norms.append(float(np.linalg.norm(B)))
        lmins.append(float(np.linalg.eigvalsh(B)[0]))
    end = sum(sd * sd for sd in layout.sdp_sides)
    se = end + sum(layout.soc_lens)
    out[what] = {"fetch": np.asarray(fetch(s)).tolist(), "norms": norms,
                 "lmins": lmins, "soc_norm": float(np.linalg.norm(x[end:se])),
                 "lp_norm": float(np.linalg.norm(x[se:]))}
print(json.dumps(out))
"""


def _hi(what: str, timeout: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", HI_CHILD, what], cwd=ROOT,
                          env={**os.environ, **ONE_THREAD},
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_phase_i_iterate_reference_values():
    """Phase I's f64 iterate after I_ITERS iterations, re-derived by the
    JAX package on one thread (~40 s): the counters exactly, the fetched
    scalars, the blocks' norms and the SOC and LP parts' norms to 1e-9
    relative, each block's lambda_min to 1e-9 of its norm."""
    k = _module_constants(SMOKE, ("I_REF_",))
    out = _hi("Isteps", 600)["Isteps"]
    got, want = out["fetch"], k["I_REF_FETCH"]
    assert got[:2] == want[:2] and got[9:11] == want[9:11]
    for g, w in zip(got[2:9], want[2:9]):
        assert abs(g - w) <= 1e-9 * abs(w)
    for g, w in zip(out["norms"], k["I_REF_NORMS"], strict=True):
        assert abs(g - w) <= 1e-9 * w
    for g, w, nrm in zip(out["lmins"], k["I_REF_LMINS"], k["I_REF_NORMS"],
                         strict=True):
        assert abs(g - w) <= 1e-9 * nrm
    assert abs(out["soc_norm"] - k["I_REF_SOC_NORM"]) <= 1e-9 * k["I_REF_SOC_NORM"]
    assert abs(out["lp_norm"] - k["I_REF_LP_NORM"]) <= 1e-9 * k["I_REF_LP_NORM"]


@pytest.mark.slow
def test_phase_hi_solve_reference_values():
    """Phase H's and I's default solves re-derived on one thread (~2
    minutes): statuses, phase I's objective to 1e-9 relative and its
    iterations exactly; H1's to 2e-4 (1 + |obj|), phase H's bound on the
    card, since its probe arms stop at the clock (20 s a round), so the
    probe's depths, scores and winner, and the solve after it, move with
    the host's speed; H2's probe (bound by its depth) exactly, its
    objective to 1e-9 relative."""
    k = _module_constants(SMOKE, ("H_REF_", "H2_REF_", "I_REF_"))
    out = _hi("H,H2,Isolve", 1800)
    res = out["Isolve"]
    assert res["status"] == k["I_REF_STATUS"]
    assert abs(res["objval"] - k["I_REF_OBJ"]) <= 1e-9 * abs(k["I_REF_OBJ"])
    assert res["iter"] == k["I_REF_ITERS"]
    res = out["H"]
    assert res["status"] == 1
    assert abs(res["objval"] - k["H_REF_OBJ"]) <= 2e-4 * (1 + abs(k["H_REF_OBJ"]))
    assert re.search(r"\[beq probe\] -> (default|block-equilibrated)", res["log"])
    res = out["H2"]
    rounds = [(int(d), float(a), float(b)) for d, a, b in re.findall(
        r"\[beq probe\] depth (\d+): default (\S+) vs block-equilibrated "
        r"(\S+)", res["log"])]
    assert rounds == k["H2_REF_PROBE"]
    assert f"[beq probe] -> {k['H2_REF_WINNER']}" in res["log"]
    assert res["status"] == 1 and res["iter"] == k["H2_REF_ITERS"]
    assert abs(res["objval"] - k["H2_REF_OBJ"]) <= 1e-9 * abs(k["H2_REF_OBJ"])


@pytest.mark.slow
def test_phase_h_equilibrated_range_and_optimum():
    """Phase H's H_EQ_REF_RANGE -- the JAX equilibrated arm solved in one
    go, and stopped at 3000 iterations then warm-started -- and the
    optimum H_OPT_OBJ (a solve at 1e-7 tolerances), re-derived on one
    thread (~15 minutes), to 1e-9 relative."""
    k = _module_constants(SMOKE, ("H_EQ_REF_", "H_OPT_"))
    out = _hi("Heq,Hopt", 3600)
    lo, hi = k["H_EQ_REF_RANGE"]
    assert out["Heq"]["status"] == [1, 3, 1]
    for got, want in zip(out["Heq"]["objval"], (lo, hi), strict=True):
        assert abs(got - want) <= 1e-9 * abs(want)
    assert out["Hopt"]["status"] == 1
    assert abs(out["Hopt"]["objval"] - k["H_OPT_OBJ"]) <= 1e-9 * abs(k["H_OPT_OBJ"])


# chip_smoke.py's phase J references: the JAX package on one thread at
# chunk_iters=256 with its clock frozen (the best-iterate snapshots and the
# search's clock deadline read it), each solve also without the search
# for the first declaration
J_CHILD = r"""
import json
import proxsdp_tpu as jx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
import chip_smoke as cs


class _Frozen:
    @staticmethod
    def time():
        return 0.0


jsolver.time = _Frozen
out = {}
for tag, build, kw in (
        ("J1", cs.j1_problem, dict(cs.J1_OPTS)),
        ("J2", cs.j2_problem, dict(cs.J2_OPTS))):
    prob = build(maxcut_problem, random_graph_weights)
    d = jx.solve(prob, jx.Options(certificate_search=False, **kw))
    r = jx.solve(prob, jx.Options(**kw))
    out[tag] = dict(status=r.status, found=bool(r.certificate_found),
                    string=r.status_string, decl=[d.status, d.iter],
                    iters=r.iter, farkas=cs.farkas(r, prob))
print(json.dumps(out))
"""


def _smoke_constant(name):
    for node in ast.parse(SMOKE.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_phase_j_problems_match_jax():
    """Phase J's programs are the same arrays through both packages'
    max-cut models (the JAX runs pin them, the card solves the port's)."""
    import chip_smoke as cs
    from proxsdp_tpu.models import maxcut as jm
    from proxsdp_tpu_torch.models import maxcut as tm

    for build in (cs.j1_problem, cs.j2_problem):
        pj = build(jm.maxcut_problem, jm.random_graph_weights)
        pt = build(tm.maxcut_problem, tm.random_graph_weights)
        for name in ("c", "b", "h"):
            np.testing.assert_array_equal(getattr(pj, name), getattr(pt, name))
        assert (abs(pj.A - pt.A)).max() == 0 and pj.A.shape == pt.A.shape
        assert pj.objective_sense == pt.objective_sense
    probs = [tm.maxcut_problem(tm.random_graph_weights(s, 6))[0]
             for s in range(max(cs.J_BAD) + 1)]
    bad = cs.j3_problems(probs)
    for i, (p, q) in enumerate(zip(probs, bad)):
        assert (q.b[0] == -1.0) == (i in cs.J_BAD)
        assert (abs(p.A - q.A)).max() == 0


@pytest.mark.slow
def test_phase_j_reference_values():
    """chip_smoke.py's J1_REF and J2_REF re-derived (~2 minutes)."""
    proc = subprocess.run([sys.executable, "-c", J_CHILD], cwd=ROOT,
                          env={**os.environ, **ONE_THREAD},
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for tag in ("J1", "J2"):
        want = _smoke_constant(f"{tag}_REF")
        g = got[tag]
        assert g["farkas"] == pytest.approx(want.pop("farkas"), rel=1e-9)
        assert {k: g[k] for k in want} == want, (tag, g)


# chip_smoke.py's phase K references: the JAX package on one thread --
# solve_batch of instances 0-7 of K1 (randsdp) and K3 (the scaled max-cut)
# at Options(tol_gap=1e-4, tol_feasibility=1e-4), projection "eigh"; K1's
# optimum (its f64 program at 1e-7); the MIMO n = 100 solves (the default
# options to K2_MIMO_MAX_ITER, the f64 program) and sensor localisation
# n = 100 at chunk_iters=256
K_CHILD = r"""
import json, sys
import numpy as np
import proxsdp_tpu as jx
from proxsdp_tpu.parallel.batch import solve_batch
from proxsdp_tpu.models import mimo, sensorloc
from proxsdp_tpu.models.maxcut import random_graph_weights
from proxsdp_tpu.models.randsdp import randsdp_problem
import chip_smoke as cs

what = sys.argv[1]
out = {}
if what == "batch":
    k1 = [randsdp_problem(s, cs.K1_SIDE, cs.K1_ROWS, varbounds=False)[0]
          for s in range(8)]
    k3 = cs.k3_problems(jx.Optimizer, random_graph_weights, 8, cs.K3_SIDE)
    for tag, probs, kw in (("K1", k1, dict(tol_gap=cs.K1_TOL,
                                           tol_feasibility=cs.K1_TOL)),
                           ("K3", k3, {}),
                           ("K1_exact", k1, dict(tol_gap=1e-7,
                                                 tol_feasibility=1e-7,
                                                 hybrid_precision=False)),
                           ("K1_f64", k1, dict(hybrid_precision=False))):
        kw = {"tol_gap": 1e-4, "tol_feasibility": 1e-4, **kw}
        res = solve_batch(probs, jx.Options(**kw), projection="eigh")
        out[tag] = dict(status=[r.status for r in res],
                        obj=[r.objval for r in res], iter=[r.iter for r in res])
elif what == "f64":
    k1 = [randsdp_problem(s, cs.K1_SIDE, cs.K1_ROWS, varbounds=False)[0]
          for s in range(8)]
    res = solve_batch(k1, jx.Options(tol_gap=1e-4, tol_feasibility=1e-4,
                                     hybrid_precision=False,
                                     max_iter=cs.K1_F64_ITERS),
                      projection="eigh")
    out = dict(obj=[r.objval for r in res],
               xnorm=[float(np.linalg.norm(r.primal)) for r in res])
else:
    p, X, s = mimo.mimo_problem(0, cs.K2_MIMO_N)
    for tag, kw in (("mimo", {}), ("mimo64", dict(hybrid_precision=False))):
        r = jx.solve(p, jx.Options(chunk_iters=256,
                                   max_iter=cs.K2_MIMO_MAX_ITER, **kw))
        out[tag] = dict(status=r.status, obj=r.objval, iter=r.iter, gap=r.gap,
                        decode=float(mimo.mimo_eval(s, r.primal[X])[1]))
    p, X, xt = sensorloc.sensorloc_problem(0, cs.K2_SL_N)
    r = jx.solve(p, jx.Options(chunk_iters=256))
    Xm = r.primal[X]
    out["sl"] = dict(status=r.status, iter=r.iter, pos_err=float(np.sqrt(
        np.mean(np.sum((Xm[:2, 2:] - xt) ** 2, axis=0)))))
print(json.dumps(out))
"""


def _k_child(what):
    proc = subprocess.run([sys.executable, "-c", K_CHILD, what], cwd=ROOT,
                          env={**os.environ, **ONE_THREAD},
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_phase_k_problems_match_jax():
    """Phase K3's programs are the same arrays through both packages (the
    JAX runs pin them, the card solves the port's)."""
    import chip_smoke as cs
    import proxsdp_tpu as jx
    import proxsdp_tpu_torch as tx
    from proxsdp_tpu.models import maxcut as jm
    from proxsdp_tpu_torch.models import maxcut as tm

    pj = cs.k3_problems(jx.Optimizer, jm.random_graph_weights, 3, 12)
    pt = cs.k3_problems(tx.Optimizer, tm.random_graph_weights, 3, 12)
    for a, b in zip(pj, pt):
        for name in ("c", "b", "h"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert (abs(a.A - b.A)).max() == 0 and a.A.shape == b.A.shape
    assert (abs(pj[0].A - pj[1].A)).max() > 0  # values per instance
    assert (pj[0].A != 0).nnz == (pj[1].A != 0).nnz


@pytest.mark.slow
def test_phase_k_reference_values():
    """chip_smoke.py's K1 (the hybrid batch, the optimum, the f64 program
    at K1_F64_ITERS), K3 and K2 references re-derived (~6 minutes), and
    the port's f64 program repeating the JAX package's on K1's instances
    0-7 to the end (iterations equal, objectives to 1e-9): the scatter of
    K1's hybrid answers about the optimum (C19) is the problem's, not a
    parting of the two programs."""
    import chip_smoke as cs
    import proxsdp_tpu_torch as tx
    from proxsdp_tpu_torch.models.randsdp import randsdp_problem

    got = {**_k_child("batch"), **_k_child("single")}
    for tag, obj, iters in (("K1", "K1_REF_OBJ", "K1_REF_ITERS"),
                            ("K3", "K3_REF_OBJ", "K3_REF_ITERS"),
                            ("K1_exact", "K1_EXACT_OBJ", None)):
        assert got[tag]["status"] == [1] * 8
        np.testing.assert_allclose(got[tag]["obj"], _smoke_constant(obj),
                                   rtol=1e-9)
        if iters:
            assert got[tag]["iter"] == _smoke_constant(iters)
    f64 = _k_child("f64")
    for key in ("obj", "xnorm"):
        np.testing.assert_allclose(f64[key], cs.K1_F64_REF[key], rtol=1e-9)
    for tag, name in (("mimo", "K2_MIMO_REF"), ("mimo64", "K2_MIMO64_REF")):
        want = _smoke_constant(name)
        obj, gap = want.pop("obj"), want.pop("gap")
        if tag == "mimo64":
            assert got[tag]["obj"] == pytest.approx(obj, rel=1e-9)
            assert got[tag]["gap"] == pytest.approx(gap, rel=1e-6)
        # the default run stops at the iteration limit, where the result is
        # the best-iterate snapshot, taken at most every 2 s of wall time:
        # its objective moves with the host's speed (printed, not held)
        assert {k: got[tag][k] for k in want} == want, (tag, got[tag])
    want = _smoke_constant("K2_SL_REF")
    assert got["sl"]["pos_err"] == pytest.approx(want.pop("pos_err"), rel=1e-6)
    assert {k: got["sl"][k] for k in want} == want
    res = tx.solve_batch(
        [randsdp_problem(s, cs.K1_SIDE, cs.K1_ROWS, varbounds=False)[0]
         for s in range(8)],
        tx.Options(tol_gap=1e-4, tol_feasibility=1e-4, hybrid_precision=False),
        projection="eigh", device="cpu")
    assert [r.iter for r in res] == got["K1_f64"]["iter"]
    for r, want in zip(res, got["K1_f64"]["obj"]):
        assert r.status == 1 and abs(r.objval - want) <= 1e-9 * (1 + abs(want))


# chip_smoke.py's phase L: the JAX package's solve_batch of L's max-cut
# instances -- "eigh": projection "eigh" (L1); "polar": the same under
# Options(projection="polar") (L3); "f64": the f64 program of the first
# instances for a number of iterations; "sub": projection "auto" (the
# subspace mode), lined up with the port as G_CHILD is (C11, C12), its
# reseeds and programs logged
L_CHILD = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
import proxsdp_tpu as jx
from proxsdp_tpu.parallel import batch as jb
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
from proxsdp_tpu_torch import kernels
what, B, side = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
probs = [maxcut_problem(random_graph_weights(s, side))[0] for s in range(B)]
opts = dict(tol_gap=1e-4, tol_feasibility=1e-4)
out = {}
if what == "f64":
    res = jb.solve_batch(probs, jx.Options(hybrid_precision=False,
                                           max_iter=int(sys.argv[4]), **opts),
                         projection="eigh")
    out = dict(obj=[r.objval for r in res],
               xnorm=[float(np.linalg.norm(r.primal)) for r in res])
elif what == "port_sub":
    import proxsdp_tpu_torch as tx
    from proxsdp_tpu_torch.parallel import batch as tb
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem as tmaxcut
    tprobs = [tmaxcut(random_graph_weights(s, side))[0] for s in range(B)]
    stats = tb.BatchStats()
    res = tx.solve_batch(tprobs, tx.Options(**opts), device="cpu",
                         stats=stats)
    it = np.array([r.iter for r in res])
    out = dict(obj=[r.objval for r in res], status=[r.status for r in res],
               iters=f"{it.min()}/{int(np.median(it))}/{it.max()}",
               reseeds=[list(r) for r in stats.reseeds],
               programs=[[d, k] for d, _, k in stats.programs])
elif what in ("eigh", "polar"):
    kw = dict(projection="polar") if what == "polar" else {}
    res = jb.solve_batch(probs, jx.Options(**opts, **kw), projection="eigh")
    out = dict(status=[r.status for r in res], obj=[r.objval for r in res],
               iter=[r.iter for r in res])
else:
    reseeds, programs, patched = [], [], []
    reseed, runner = jb._reseed_batch, jb._cached_batch_runner
    def logged_reseed(states, layout, k, mask, c_np, opts):
        it = np.asarray(states.iter)
        out, r = reseed(states, layout, k, mask, c_np, opts)
        reseeds.append([str(np.asarray(states.x).dtype), int(it.min()),
                        int(it.max()), int(k), int(np.sum(mask)), int(r)])
        return out, r
    def fetch_latest(ss):
        i = (ss.iter - 1) % ss.buf_gap.shape[1]
        take = jax.vmap(lambda buf, j: buf[j])
        ft = ss.buf_gap.dtype
        return jnp.stack([ss.iter.astype(ft), ss.status.astype(ft),
                          take(ss.buf_gap, i), take(ss.buf_feas, i),
                          take(ss.buf_prim_obj, i), take(ss.buf_dual_obj, i),
                          ss.sub_worst.astype(ft)], axis=-1)
    def logged_runner(layout, opts, m_kind="shared"):
        programs.append([opts.dtype, int(opts.subspace_rank)])
        run, _ = runner(layout, opts, m_kind)
        def run_patched(states, ops):
            if not patched and states.warm[0].ndim == 3:
                patched.append(True)
                V = torch.tensor(np.asarray(states.warm[0]))
                states = run(states,
                             ops._replace(chunk_end=jnp.asarray(1, jnp.int32)))
                eps = kernels.CHOLQR_EPS[V.dtype]
                Q = kernels._cholqr_batch_plain(
                    kernels._cholqr_batch_plain(V, eps), eps)
                states = states._replace(warm=(jnp.asarray(Q.flip(-1).numpy()),))
            return run(states, ops)
        return run_patched, jax.jit(fetch_latest)
    jb._reseed_batch, jb._cached_batch_runner = logged_reseed, logged_runner
    res = jb.solve_batch(probs, jx.Options(**opts))
    jb._reseed_batch, jb._cached_batch_runner = reseed, runner
    it = np.array([r.iter for r in res])
    out = dict(obj=[r.objval for r in res], status=[r.status for r in res],
               iters=f"{it.min()}/{int(np.median(it))}/{it.max()}",
               reseeds=reseeds, programs=programs)
print(json.dumps(out))
"""


def _l_child(*args, timeout=1800, env=ONE_THREAD):
    proc = subprocess.run([sys.executable, "-c", L_CHILD, *map(str, args)],
                          cwd=ROOT, env={**os.environ, **env},
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _l_constants() -> dict:
    return _module_constants(SMOKE, ("L_", "L1_", "L2_", "L3_"))


def test_phase_l_constants_are_consistent():
    """chip_smoke.py's phase L constants hang together: one objective and
    iteration count per instance, the polar answers within 2e-4 (1 + |obj|)
    of the eigh ones (the same optima), the side-500 run's reseeds start
    at iteration 128 on bucket 16 with every instance, and its programs
    start with the f32 subspace program at 16 and pass one block's shared
    memory (an f32 bucket of 32 or more) before the f64 phase."""
    k = _l_constants()
    B = k["L_SIZE"]
    for name in ("L1_REF_OBJ", "L1_REF_ITERS", "L3_REF_OBJ", "L3_REF_ITERS"):
        assert len(k[name]) == B, name
    for a, b in zip(k["L1_REF_OBJ"], k["L3_REF_OBJ"]):
        assert abs(a - b) <= 2e-4 * (1 + abs(a))
    assert len(k["L2_REF_OBJ"]) == k["L2_SIZE"] > 32
    res, prg = k["L2_REF_RESEEDS"], k["L2_REF_PROGRAMS"]
    assert res[0][:5] == ("float32", 128, 128, 16, k["L2_SIZE"])
    assert prg[0] == ("float32", 16) and prg[-1][0] == "float64"
    assert any(d == "float32" and kk >= 32 for d, kk in prg)
    assert len(k["L1_F64_REF"]["obj"]) == k["L_F64_SIZE"]


@pytest.mark.slow
def test_phase_l_reference_values():
    """chip_smoke.py's phase L constants re-derived by the JAX package on
    one CPU thread (~17 minutes; L2 at side 500 ~15 of them): L1's and
    L3's statuses, objectives (1e-9 relative) and iterations, L1's f64
    program, L2's objectives, iterations, reseeds and programs."""
    k = _l_constants()
    side, B = k["L_SIDE"], k["L_SIZE"]
    for what, obj, iters in (("eigh", "L1_REF_OBJ", "L1_REF_ITERS"),
                             ("polar", "L3_REF_OBJ", "L3_REF_ITERS")):
        got = _l_child(what, B, side)
        assert got["status"] == [1] * B
        np.testing.assert_allclose(got["obj"], k[obj], rtol=1e-9)
        assert got["iter"] == k[iters]
    got = _l_child("f64", k["L_F64_SIZE"], side, k["L_F64_ITERS"])
    for key in ("obj", "xnorm"):
        np.testing.assert_allclose(got[key], k["L1_F64_REF"][key], rtol=1e-9)
    got = _l_child("sub", k["L2_SIZE"], k["L2_SIDE"], timeout=3600)
    assert got["status"] == [1] * k["L2_SIZE"]
    np.testing.assert_allclose(got["obj"], k["L2_REF_OBJ"], rtol=1e-9)
    assert got["iters"] == k["L2_REF_ITERS"]
    assert [tuple(r) for r in got["reseeds"]] == k["L2_REF_RESEEDS"]
    assert [tuple(p) for p in got["programs"]] == k["L2_REF_PROGRAMS"]


# L2's runs that differ from the reference run in rounding alone: the JAX
# package with XLA's code generation stopped at AVX (no FMA contraction,
# C17), and the port's plain path on the CPU (torch's matmul and LAPACK's
# eigh where XLA's are)
L2_WITNESSES = {
    "jax_no_fma": ("sub", {**ONE_THREAD, "XLA_FLAGS": (
        "--xla_cpu_multi_thread_eigen=false --xla_cpu_max_isa=AVX")}),
    "port_cpu": ("port_sub", ONE_THREAD),
}


@pytest.mark.slow
@pytest.mark.parametrize("witness", sorted(L2_WITNESSES))
def test_phase_l2_rounding_scatter(witness):
    """Phase L2's objective bounds (L2_OBJ_RTOL each, L2_OBJ_MEAN_RTOL on
    average, relative to 1 + |obj|) hold between the JAX reference run and
    a run that differs from it in rounding only (on one thread: ~17
    minutes the JAX run, ~56 the port's plain path).  Prints the
    deviations and the reseed and program sequences beside the
    reference's (C14)."""
    k = _l_constants()
    what, env = L2_WITNESSES[witness]
    got = _l_child(what, k["L2_SIZE"], k["L2_SIDE"], timeout=7200, env=env)
    ref = np.array(k["L2_REF_OBJ"])
    dev = np.abs(np.array(got["obj"]) - ref) / (1 + np.abs(ref))
    print(f"{witness}: objectives vs L2_REF_OBJ max {dev.max():.3e} "
          f"(instance {int(dev.argmax())}), mean {dev.mean():.3e}; "
          f"iterations {got['iters']} (reference {k['L2_REF_ITERS']}); "
          f"reseeds {got['reseeds']}; programs {got['programs']}")
    assert got["status"] == [1] * k["L2_SIZE"]
    assert dev.max() <= k["L2_OBJ_RTOL"]
    assert dev.mean() <= k["L2_OBJ_MEAN_RTOL"]


# chip_smoke.py's phase M: the JAX package's solve_batch of the sweep over
# phase I's program (chip_smoke.conic_sweep_instance: phase I's operator,
# each instance's b and c from default_rng(s)) on one CPU thread --
# "eigh": projection "eigh" under Options(tol_gap=1e-4,
# tol_feasibility=1e-4) (M1); "f64": its f64 program on the first
# instances for a number of iterations; "sub": projection "subspace" (M2),
# lined up with the port as G_CHILD is (C11, C12) on every subspace block,
# its reseeds and programs logged
M_CHILD = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
import proxsdp_tpu as jx
from proxsdp_tpu.parallel import batch as jb
from proxsdp_tpu_torch import kernels
import chip_smoke as cs
what, B = sys.argv[1], int(sys.argv[2])
data = cs.conic_program_data()
probs = [cs.build_conic_program(jx, cs.conic_sweep_instance(data, s))[0]
         for s in range(B)]
opts = dict(tol_gap=1e-4, tol_feasibility=1e-4)
if what == "f64":
    res = jb.solve_batch(probs, jx.Options(hybrid_precision=False,
                                           max_iter=int(sys.argv[3]), **opts),
                         projection="eigh")
    out = dict(obj=[r.objval for r in res],
               xnorm=[float(np.linalg.norm(r.primal)) for r in res])
elif what == "eigh":
    res = jb.solve_batch(probs, jx.Options(**opts), projection="eigh")
    out = dict(status=[r.status for r in res], obj=[r.objval for r in res],
               iter=[r.iter for r in res])
else:
    reseeds, programs, patched = [], [], []
    reseed, runner = jb._reseed_batch, jb._cached_batch_runner
    def logged_reseed(states, layout, k, mask, c_np, opts):
        it = np.asarray(states.iter)
        out, r = reseed(states, layout, k, mask, c_np, opts)
        reseeds.append([str(np.asarray(states.x).dtype), int(it.min()),
                        int(it.max()), int(k), int(np.sum(mask)), int(r)])
        return out, r
    def fetch_latest(ss):
        i = (ss.iter - 1) % ss.buf_gap.shape[1]
        take = jax.vmap(lambda buf, j: buf[j])
        ft = ss.buf_gap.dtype
        return jnp.stack([ss.iter.astype(ft), ss.status.astype(ft),
                          take(ss.buf_gap, i), take(ss.buf_feas, i),
                          take(ss.buf_prim_obj, i), take(ss.buf_dual_obj, i),
                          ss.sub_worst.astype(ft)], axis=-1)
    def logged_runner(layout, opts, m_kind="shared"):
        programs.append([opts.dtype, int(opts.subspace_rank)])
        run, _ = runner(layout, opts, m_kind)
        def run_patched(states, ops):
            if not patched and any(w.ndim == 3 for w in states.warm):
                patched.append(True)
                starts = [np.asarray(w) for w in states.warm]
                states = run(states,
                             ops._replace(chunk_end=jnp.asarray(1, jnp.int32)))
                warm = list(states.warm)
                for bi, V in enumerate(starts):
                    if V.ndim == 3:
                        V = torch.tensor(V)
                        eps = kernels.CHOLQR_EPS[V.dtype]
                        Q = kernels._cholqr_batch_plain(
                            kernels._cholqr_batch_plain(V, eps), eps)
                        warm[bi] = jnp.asarray(Q.flip(-1).numpy())
                states = states._replace(warm=tuple(warm))
            return run(states, ops)
        return run_patched, jax.jit(fetch_latest)
    jb._reseed_batch, jb._cached_batch_runner = logged_reseed, logged_runner
    res = jb.solve_batch(probs, jx.Options(**opts), projection="subspace")
    jb._reseed_batch, jb._cached_batch_runner = reseed, runner
    it = np.array([r.iter for r in res])
    out = dict(obj=[r.objval for r in res], status=[r.status for r in res],
               iters=f"{it.min()}/{int(np.median(it))}/{it.max()}",
               reseeds=reseeds, programs=programs)
print(json.dumps(out))
"""


def _m_child(*args, timeout=3600, env=ONE_THREAD):
    proc = subprocess.run([sys.executable, "-c", M_CHILD, *map(str, args)],
                          cwd=ROOT, env={**os.environ, **env},
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _m_constants() -> dict:
    return _module_constants(SMOKE, ("M_", "M1_", "M2_"))


def test_phase_m_constants_are_consistent():
    """chip_smoke.py's phase M constants hang together: one objective and
    iteration count per instance, the subspace mode's answers within 5e-3
    (1 + |obj|) of the eigh mode's (the same optima), its reseeds start at
    iteration 128 on bucket 16 with every instance and its programs with
    the f32 subspace program at 16; the sweep's instances differ."""
    k = _m_constants()
    B = k["M_SIZE"]
    assert len(k["M1_REF_OBJ"]) == len(k["M1_REF_ITERS"]) == B
    assert len(k["M2_REF_OBJ"]) == B
    for a, b in zip(k["M1_REF_OBJ"], k["M2_REF_OBJ"]):
        assert abs(a - b) <= 5e-3 * (1 + abs(a))
    assert len(set(k["M1_REF_OBJ"])) == B
    res, prg = k["M2_REF_RESEEDS"], k["M2_REF_PROGRAMS"]
    assert res[0][:5] == ("float32", 128, 128, 16, B)
    assert prg[0] == ("float32", 16) and prg[-1][0] == "float64"
    assert len(k["M1_F64_REF"]["obj"]) == k["M_F64_SIZE"]


@pytest.mark.slow
def test_phase_m_reference_values():
    """chip_smoke.py's phase M constants re-derived by the JAX package on
    one CPU thread: M1's statuses, objectives (1e-9 relative) and
    iterations, its f64 program, M2's objectives, iterations, reseeds and
    programs."""
    k = _m_constants()
    B = k["M_SIZE"]
    got = _m_child("eigh", B)
    assert got["status"] == [1] * B
    np.testing.assert_allclose(got["obj"], k["M1_REF_OBJ"], rtol=1e-9)
    assert got["iter"] == k["M1_REF_ITERS"]
    got = _m_child("f64", k["M_F64_SIZE"], k["M_F64_ITERS"])
    for key in ("obj", "xnorm"):
        np.testing.assert_allclose(got[key], k["M1_F64_REF"][key], rtol=1e-9)
    got = _m_child("sub", B)
    assert got["status"] == [1] * B
    np.testing.assert_allclose(got["obj"], k["M2_REF_OBJ"], rtol=1e-9)
    assert got["iters"] == k["M2_REF_ITERS"]
    assert [tuple(r) for r in got["reseeds"]] == k["M2_REF_RESEEDS"]
    assert [tuple(p) for p in got["programs"]] == k["M2_REF_PROGRAMS"]


# Phase N (chip_smoke.py): the single solve's options on the side-250
# max-cut.  N1 the packed layout under the default driver (chunk_iters=256)
# and its f64 program's iterate after N_ITERS iterations; N2 the
# sign-based subspace race; N3 the accept-always step's f64 program (mixed,
# and with subspace_mixed=False) in both layouts, lined up for C11 -- after
# iteration 1 the JAX run gets the basis the port's first iteration
# computes on the CPU.
N_CHILD = """
import contextlib, io, json, re, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, ".")
import chip_smoke as cs
import proxsdp_tpu as jx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.models.maxcut import maxcut_problem, random_graph_weights
from proxsdp_tpu.ops.linop import build_linop
from proxsdp_tpu.problem import preprocess, to_square_form
import proxsdp_tpu_torch as tx
from proxsdp_tpu_torch import convert
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.ops.linop import build_linop as tbuild_linop
problem, _ = maxcut_problem(random_graph_weights(0, cs.SIDE))
out = {}


def events(log):
    race = re.search(r"f32 race: subspace rank (\\d+)", log)
    hand = re.search(r"f32 -> f64 at iter (\\d+)", log)
    fb = re.search(r"f32 polar-reseed=(\\d+), dense-eigh=(\\d+)", log)
    return [int(race.group(1)) if race else 0, int(hand.group(1)) if hand else 0,
            int(fb.group(1)) if fb else -1]


def steps(opts, square, c11):
    setup = preprocess(problem)
    if square:
        setup = to_square_form(setup)
    layout = setup.layout
    o = jsolver.Operands(
        M=build_linop(setup.A, setup.G, jnp.float64), b=jnp.asarray(setup.b),
        h=jnp.asarray(setup.h), c=jnp.asarray(setup.c),
        norm_b=jnp.asarray(setup.norm_b), norm_h=jnp.asarray(setup.norm_h),
        norm_c=jnp.asarray(setup.norm_c), chunk_end=jnp.asarray(0, jnp.int32),
        obj_scale=jnp.asarray(setup.obj_scale * setup.rhs_scale))
    _, it, fetch = jsolver.make_chunk_runner(layout, opts)
    it = jax.jit(it)
    init = jsolver.init_state(layout, opts, setup)
    s = jax.tree_util.tree_map(jnp.asarray, init)
    for k in range(cs.N_ITERS):
        s = it(s, o)
        if k == 0 and c11:
            host = {f: np.asarray(getattr(init, f)) for f in init._fields
                    if f != "warm"}
            host["warm"] = tuple(np.asarray(w) for w in init.warm)
            topts = tx.Options(**{f: getattr(opts, f) for f in
                                  ("hybrid_precision", "subspace_rank",
                                   "subspace_accept_always", "square_form",
                                   "subspace_mixed")})
            to = convert.operands_from_numpy(
                M=tbuild_linop(setup.A, setup.G, torch.float64, device="cpu"),
                b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
                norm_h=setup.norm_h, norm_c=setup.norm_c,
                obj_scale=setup.obj_scale * setup.rhs_scale, device="cpu")
            t_it = tsolver.make_chunk_runner(layout, topts, device="cpu")[1]
            st = t_it(convert.state_from_numpy(host, "cpu"), to, 0)
            s = s._replace(warm=tuple(jnp.asarray(w.numpy()) for w in st.warm))
    x = np.asarray(s.x)
    X = cs.block_of(x, cs.SIDE, square)
    return {"fetch": np.asarray(fetch(s)).tolist(),
            "norm": float(np.linalg.norm(X)),
            "lmin": float(np.linalg.eigvalsh(X)[0])}


for what in sys.argv[1].split(","):
    if what in ("N1", "N2"):
        kw = dict(square_form=False) if what == "N1" else dict(subspace_sign=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = jx.solve(problem, jx.Options(chunk_iters=256, log_verbose=True,
                                               log_freq=10**9, timer_verbose=True,
                                               **kw))
        out[what] = {"status": res.status, "objval": res.objval,
                     "iter": res.iter, "events": events(buf.getvalue())}
    elif what == "N1f64":
        out[what] = steps(jx.Options(hybrid_precision=False, square_form=False),
                          False, False)
    else:  # N3sq, N3tri (the mixed basis), N3f64sq, N3f64tri
        square = what.endswith("sq")
        out[what] = steps(jx.Options(**cs.N3_OPTS, square_form=square,
                                     subspace_mixed="f64" not in what),
                          square, True)
print(json.dumps(out))
"""


def _n_child(what: str, timeout=1800) -> dict:
    proc = subprocess.run([sys.executable, "-c", N_CHILD, what], cwd=ROOT,
                          env={**os.environ, **ONE_THREAD},
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _n_constants() -> dict:
    return _module_constants(SMOKE, ("N_", "N1_", "N2_", "N3_", "N4_",
                                     "HYB_REF_", "REF_"))


def test_phase_n_constants_are_consistent():
    """chip_smoke.py's phase N constants hang together: the packed
    layout's default solve within phase C's bound (1e-4 (1 + |obj|)) and 2
    iterations of the square layout's reference, the sign race's within
    N2's bound of it, the race entering its subspace step at phase C's
    rank; the accept-always iterate the same in both layouts (1e-9: the
    unitary embedding), its counters those of N_ITERS iterations without
    a fallback; N4's saves inside the runs they cut."""
    k = _n_constants()
    n1, n2, n3 = k["N1_REF"], k["N2_REF"], k["N3_REF"]
    assert n1["status"] == n2["status"] == 1
    assert abs(n1["objval"] - k["HYB_REF_OBJ"]) <= 1e-4 * (1 + abs(k["HYB_REF_OBJ"]))
    assert abs(n1["iter"] - k["HYB_REF_ITERS"]) <= 2
    assert abs(n2["objval"] - k["HYB_REF_OBJ"]) <= k["N2_OBJ_RTOL"] * (
        1 + abs(k["HYB_REF_OBJ"]))
    assert n1["events"][0] == n2["events"][0] == k["HYB_REF_RACE_RANK"]
    for prog in ("N3", "N3f64"):
        sq, tri = n3[prog + "sq"], n3[prog + "tri"]
        assert sq["fetch"][:2] == tri["fetch"][:2] == [k["N_ITERS"], 0.0]
        assert sq["fetch"][10] == 0.0  # no fallback in the accept-always step
        np.testing.assert_allclose(sq["fetch"][2:9], tri["fetch"][2:9],
                                   rtol=1e-9)
        assert abs(sq["norm"] - tri["norm"]) <= 1e-9 * sq["norm"]
    # the mixed program's objectives and norm stay near the f64 one's
    for i in (4, 5):
        assert abs(n3["N3sq"]["fetch"][i] - n3["N3f64sq"]["fetch"][i]) <= (
            1e-4 * abs(n3["N3f64sq"]["fetch"][i]))
    f64 = k["N1_F64_REF"]["fetch"]
    assert f64[:2] == [k["N_ITERS"], 0.0] and f64[10] == k["N_ITERS"]
    assert 2 * k["N4_SAVE"] < k["REF_ITERS"]
    assert n1["events"][0] and k["N4_RACE_SAVE"] < n1["events"][1]


@pytest.mark.slow
def test_phase_n_reference_values():
    """chip_smoke.py's phase N constants re-derived by the JAX package on
    one CPU thread (~1 minute): N1's and N2's statuses, objectives (1e-9
    relative), iterations and events; the f64 and accept-always iterates
    (the counters exactly, the rest to 1e-9 relative)."""
    k = _n_constants()
    out = _n_child("N1,N2,N1f64,N3sq,N3tri,N3f64sq,N3f64tri")
    for tag in ("N1", "N2"):
        got, want = out[tag], k[f"{tag}_REF"]
        assert got["status"] == want["status"]
        assert abs(got["objval"] - want["objval"]) <= 1e-9 * abs(want["objval"])
        assert got["iter"] == want["iter"] and got["events"] == want["events"]
    for tag in ("N1f64", "N3sq", "N3tri", "N3f64sq", "N3f64tri"):
        got = out[tag]
        want = k["N1_F64_REF"] if tag == "N1f64" else k["N3_REF"][tag]
        assert got["fetch"][:2] == want["fetch"][:2]
        assert got["fetch"][9:11] == want["fetch"][9:11]
        np.testing.assert_allclose(got["fetch"][2:9], want["fetch"][2:9],
                                   rtol=1e-9)
        assert abs(got["norm"] - want["norm"]) <= 1e-9 * want["norm"]
        assert abs(got["lmin"] - want["lmin"]) <= 1e-9 * want["norm"]
