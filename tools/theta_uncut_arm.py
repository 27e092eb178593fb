#!/usr/bin/env python3
"""One uncut solve of phase H's Lovasz-theta SDP: the path the
block-equilibration probe's default arm takes when it solves inside its
round.

    python3 tools/theta_uncut_arm.py [--root DIR] [--device cuda|cpu]
                                     [--threads N] [--f64] [--jax]
                                     [--dump-race FILE] [--race FILE]
                                     [--series FILE]
    python3 tools/theta_uncut_arm.py --compare FILE FILE [FILE ...]

Solves ``chip_smoke.py``'s theta instance (300 vertices, 4374 edges:
SDPLIB theta6's shape) once with Options(chunk_iters=256,
block_equilibration=False) -- the default arm of the probe, not cut --
through the port of ``--root``'s checkout (default: this one) on
``--device`` (default: the card), or with ``--f64`` its f64 program
(hybrid_precision=False).  ``--jax`` runs the JAX package on the CPU
instead, as the reference (the machine with the card has no JAX).
Prints the hybrid driver's events and one line: status, objective,
iterations, seconds.  ``--threads`` sets torch's CPU threads.

``--dump-race FILE`` writes the hand-over from the f32 race to the f64
polish: the race's last state and the polish's first (after the step
reset of a stalled race and the seeded subspace bases), every State
field as NumPy arrays, pickled.  ``--race FILE`` puts both, written by
either package, in place of the run's own, so that the polish of one
package runs from the race end of the other (phase H1's
H_UNCUT_REF_RANGE).  ``--series FILE`` writes the polish's objective,
dual objective, gap and feasibility at every iteration (read from the
rings at each chunk's end), a dict by iteration, pickled; ``--compare``
prints, for each pair of such files, the first polish iteration at which
their objectives part by 1e-8, 1e-6, 1e-4 and 1e-3 relative, and where
each stops.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import pathlib
import pickle
import sys
import time

import numpy as np


def compare(paths) -> int:
    runs = {}
    for p in paths:
        with open(p, "rb") as f:
            runs[p] = pickle.load(f)
    for i, a in enumerate(paths):
        for b in paths[i + 1:]:
            sa, sb = runs[a], runs[b]
            common = sorted(set(sa) & set(sb))
            parts = []
            for tol in (1e-8, 1e-6, 1e-4, 1e-3):
                k = next((k for k in common if abs(sa[k][0] - sb[k][0])
                          > tol * abs(sb[k][0])), None)
                parts.append(f"{tol:g} at {k}")
            print(f"{a} / {b}: objectives part by " + ", ".join(parts))
    for p, s in runs.items():
        k = max(s)
        print(f"{p}: stops at {k}, objective {s[k][0]!r}")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--compare"]:
        return compare(sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--dump-race", default="")
    ap.add_argument("--race", default="")
    ap.add_argument("--series", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import chip_smoke

    kw = {}
    if args.jax:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        import proxsdp_tpu as pkg
        from proxsdp_tpu import solver

        def to_numpy(s):
            d = {k: np.asarray(v) for k, v in s._asdict().items()
                 if k != "warm"}
            d["warm"] = tuple(np.asarray(w) for w in s.warm)
            return d

        def from_numpy(s, d):
            return s._replace(**{k: (tuple(jnp.asarray(w) for w in v)
                                     if k == "warm" else jnp.asarray(v))
                                 for k, v in d.items()})

        def is_handover(s, dtype):
            return np.asarray(s.x).dtype == np.float32 and dtype == jnp.float64
    else:
        import torch

        import proxsdp_tpu_torch as pkg
        from proxsdp_tpu_torch import convert, kernels, solver

        if args.threads:
            torch.set_num_threads(args.threads)
        kw["device"] = args.device
        if args.device == "cuda":
            kernels.load()

        def to_numpy(s):
            return convert.state_to_numpy(s)

        def from_numpy(s, d):
            return convert.state_from_numpy(d, s.x.device)

        def is_handover(s, dtype):
            return s.x.dtype == torch.float32 and dtype == torch.float64

    # the hand-over, hooked twice: at the driver's one f32 -> f64 cast (the
    # race's end, from which the driver sizes the polish's subspace) and at
    # the first f64 chunk (the polish's start: the cast state after the
    # driver's step reset, if the race stalled, and its seeded bases)
    saved, given = {}, None
    if args.race:
        with open(args.race, "rb") as f:
            given = pickle.load(f)

    def swap(kind, s):
        saved[kind] = to_numpy(s)
        if set(saved) == {"race", "polish"} and args.dump_race:
            with open(args.dump_race, "wb") as f:
                pickle.dump(saved, f)
        if given is None:
            return s
        if set(given[kind]) != set(saved[kind]):
            raise ValueError(f"{args.race}: not a State of this program")
        return from_numpy(s, given[kind])

    cast = solver._cast_state

    def handover(s, dtype):
        if is_handover(s, dtype) and "race" not in saved:
            s = swap("race", s)
        return cast(s, dtype)

    series = {}

    def record(s):
        d = to_numpy(s)
        L = d["buf_gap"].shape[-1]
        first = max(int(d["iter"]) - L, int(saved["polish"]["iter"])) + 1
        for j in range(first, int(d["iter"]) + 1):
            series[j] = tuple(float(d[f][(j - 1) % L]) for f in (
                "buf_prim_obj", "buf_dual_obj", "buf_gap", "buf_feas"))

    def first_f64_chunk(run_chunk):
        def run(s, *rest):
            f64 = "race" in saved and to_numpy(s)["x"].dtype == np.float64
            if f64 and "polish" not in saved:
                s = swap("polish", s)
            s = run_chunk(s, *rest)
            if f64 and args.series:
                record(s)
            return s
        return run

    solver._cast_state = handover
    name = "_cached_runner" if args.jax else "make_chunk_runner"
    make = getattr(solver, name)

    def runner(*a, **k):
        run_chunk, *rest = make(*a, **k)
        return (first_f64_chunk(run_chunk), *rest)

    setattr(solver, name, runner)
    problem, _ = chip_smoke.build_theta(pkg, chip_smoke.theta_graph())
    opts = pkg.Options(chunk_iters=256, block_equilibration=False,
                       log_verbose=True, log_freq=10 ** 9,
                       **({"hybrid_precision": False} if args.f64 else {}))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = pkg.solve(problem, opts, **kw)
    if not args.jax and args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        if "[hybrid]" in line:
            print(line.strip())
    if args.series:
        with open(args.series, "wb") as f:
            pickle.dump(series, f)
    for kind in ("race", "polish"):
        if kind in saved:
            st = given[kind] if given else saved[kind]
            print(f"{kind} {'given' if given else 'own'}: iteration "
                  f"{int(st['iter'])}, sum(x) "
                  f"{float(np.sum(st['x'], dtype=np.float64))!r}, primal step "
                  f"{float(st['primal_step'])!r}")
    print(f"{'jax' if args.jax else args.root} "
          f"{'f64 program' if args.f64 else 'hybrid'}: status {res.status} "
          f"objval {res.objval!r} iterations {res.iter} wall {wall:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
