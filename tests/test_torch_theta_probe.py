"""The constants of chip_smoke.py's phase H3 and H1's H_UNCUT_REF_RANGE.

H3 runs phase H's Lovasz-theta SDP through the block-equilibration
probe with both arms cut at depth H3_PROBE_ITERS.  The JAX package's
side is re-derived on one CPU thread with its clock frozen: its arms
take longer than a round's 20 s on one thread, and a frozen clock lets
the depth stop them, as it does on the card.  H3_REF_DEFAULT_OBJ is the
default arm cut at that depth and warm-solved, the path the probe takes
when the default arm wins (as it does on the card).

H1's H_UNCUT_REF_ANSWERS are the JAX package's answers to the default
arm solved uncut, each from one f32 race end: the JAX package's own
race, and the race ends of the port's runs, whose hand-over
``tools/theta_uncut_arm.py --dump-race`` writes and ``--race`` puts in
place of the JAX run's own.  The port's CPU race end (two threads) is
re-derived here; the card's needs the card.
"""

import ast
import json
import os
import pathlib
import pickle
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMOKE = ROOT / "chip_smoke.py"
TOOL = ROOT / "tools" / "theta_uncut_arm.py"
ONE_THREAD = {
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
    "OPENBLAS_NUM_THREADS": "1",
    "OMP_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
}


def _constants(prefixes) -> dict:
    out = {}
    for node in ast.parse(SMOKE.read_text()).body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if (name or "").startswith(prefixes):
                try:
                    out[name] = ast.literal_eval(node.value)
                except ValueError:  # a value computed from other constants
                    pass
    return out


H3_CHILD = """
import contextlib, io, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, ".")
import chip_smoke as cs
import proxsdp_tpu as jx
from proxsdp_tpu import solver as jsolver


class Frozen:
    @staticmethod
    def time():
        return 0.0


problem, X = cs.build_theta(jx, cs.theta_graph())
for beq in (False, True):  # compile both arms' programs first
    jx.solve(problem, jx.Options(chunk_iters=256, max_iter=1,
                                 block_equilibration=beq))
jsolver.time = Frozen
out = {}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    res = jx.solve(problem, jx.Options(
        chunk_iters=256, log_verbose=True, log_freq=10**9,
        block_equilibration_probe_iters=cs.H3_PROBE_ITERS))
out["H3"] = {"status": res.status, "objval": res.objval, "iter": res.iter,
             "log": buf.getvalue()}
# the default arm cut at the probe's depth, then warm-solved
opts = jx.Options(chunk_iters=256, block_equilibration=False)
arm = jx.solve(problem, opts.replace(
    max_iter=cs.H3_PROBE_ITERS, time_limit=20.0, certificate_search=False,
    log_verbose=False, timer_verbose=False, warn_on_limit=False,
    checkpoint_path=""))
res = jx.solve(problem, opts, warm_start=arm)
out["H3def"] = {"status": [arm.status, res.status], "objval": res.objval,
                "iter": [arm.iter, res.iter]}
print(json.dumps(out))
"""


def test_uncut_range_holds_its_answers():
    """H_UNCUT_REF_RANGE spans H_UNCUT_REF_ANSWERS, whose entries name
    their race ends, and holds the JAX default arm's cut-and-warm-solved
    answers (H_REF_OBJ, H3_REF_DEFAULT_OBJ), which lie between the
    uncut ones."""
    k = _constants(("H_UNCUT_REF_", "H_REF_", "H3_REF_"))
    answers = k["H_UNCUT_REF_ANSWERS"]
    assert {"the JAX race, one thread", "the port's CPU race",
            "the port's card race"} <= set(answers)
    lo, hi = min(answers.values()), max(answers.values())
    src = SMOKE.read_text()
    assert re.search(r"^H_UNCUT_REF_RANGE = \(min\(H_UNCUT_REF_ANSWERS\.values"
                     r"\(\)\),\s*max\(H_UNCUT_REF_ANSWERS\.values\(\)\)\)",
                     src, re.M)
    for obj in (k["H_REF_OBJ"], k["H3_REF_DEFAULT_OBJ"]):
        assert lo < obj < hi


@pytest.mark.slow
def test_phase_h3_reference_values():
    """H3's probe (each arm cut at its depth, on a frozen clock) re-derived
    on one thread (~10 minutes): its rounds, winner, iterations and
    objective exactly; the default arm cut at the same depth and
    warm-solved (H3_REF_DEFAULT_OBJ) to 1e-9 relative."""
    k = _constants(("H3_REF_",))
    proc = subprocess.run([sys.executable, "-c", H3_CHILD], cwd=ROOT,
                          env={**os.environ, **ONE_THREAD},
                          capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    res = out["H3"]
    rounds = [(int(d), float(a), float(b)) for d, a, b in re.findall(
        r"\[beq probe\] depth (\d+): default (\S+) vs block-equilibrated "
        r"(\S+)", res["log"])]
    assert rounds == k["H3_REF_PROBE"]
    assert f"[beq probe] -> {k['H3_REF_WINNER']}" in res["log"]
    assert res["status"] == 1 and res["iter"] == k["H3_REF_ITERS"]
    assert abs(res["objval"] - k["H3_REF_OBJ"]) <= 1e-9 * abs(k["H3_REF_OBJ"])
    res = out["H3def"]
    assert res["status"] == [3, 1]
    assert (abs(res["objval"] - k["H3_REF_DEFAULT_OBJ"])
            <= 1e-9 * abs(k["H3_REF_DEFAULT_OBJ"]))


@pytest.mark.slow
def test_uncut_answer_from_the_port_cpu_race_end(tmp_path):
    """H_UNCUT_REF_ANSWERS["the port's CPU race"] re-derived (~4
    minutes): the port's uncut default arm on two CPU threads writes its
    hand-over, and the JAX package's polish from it stops at that answer
    (1e-9 relative); the port's own answer from it lies within phase H's
    bound, 2e-4 (1 + |obj|), of the range."""
    k = _constants(("H_UNCUT_REF_",))
    race = tmp_path / "race.pkl"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    port = subprocess.run(
        [sys.executable, str(TOOL), "--device", "cpu", "--threads", "2",
         "--dump-race", str(race)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=1800)
    assert port.returncode == 0, port.stderr[-4000:]
    with open(race, "rb") as f:
        assert set(pickle.load(f)) == {"race", "polish"}
    jax_run = subprocess.run(
        [sys.executable, str(TOOL), "--jax", "--race", str(race)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=1800)
    assert jax_run.returncode == 0, jax_run.stderr[-4000:]

    def answer(out):
        m = re.search(r"status (\d+) objval (\S+) iterations", out)
        return int(m.group(1)), float(m.group(2))

    status, obj = answer(jax_run.stdout)
    want = k["H_UNCUT_REF_ANSWERS"]["the port's CPU race"]
    assert status == 1 and abs(obj - want) <= 1e-9 * abs(want)
    lo, hi = (min(k["H_UNCUT_REF_ANSWERS"].values()),
              max(k["H_UNCUT_REF_ANSWERS"].values()))
    status, obj = answer(port.stdout)
    bound = 2e-4 * (1 + max(abs(lo), abs(hi)))
    assert status == 1 and lo - bound <= obj <= hi + bound
