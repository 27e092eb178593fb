"""Rank jobs of the port's multi-process tests (not a test module).

``proxsdp_tpu_torch.parallel.dist.spawn`` runs ``run_jobs`` on every rank
of a gloo mesh of CPU processes; each job returns plain host data.  This
module imports the port only: the JAX references are computed in the
parent test process.
"""

from __future__ import annotations

import numpy as np
import torch

from proxsdp_tpu_torch import Optimizer, Options, convert, solve_batch
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
from proxsdp_tpu_torch.ops.linop import build_linop, shard_linop
from proxsdp_tpu_torch.parallel.batch import BatchStats
from proxsdp_tpu_torch.parallel.dist import RankDivergence
from proxsdp_tpu_torch.parallel.sharded import solve_sharded, tp_context
from proxsdp_tpu_torch.problem import preprocess, to_square_form


def maxcut(seed: int, side: int, bump: float = 0.0):
    """The max-cut problem of ``random_graph_weights(seed, side)``, one
    edge weight moved by ``bump``."""
    W = random_graph_weights(seed, side)
    W[0, 1] += bump
    W[1, 0] += bump
    return maxcut_problem(W)[0]


def summary(res) -> dict:
    return {"status": res.status, "objval": res.objval, "iter": res.iter,
            "primal": res.primal, "dual_eq": res.dual_eq}


def program_iterate(problem, opts: Options, iters: int, axis=None) -> dict:
    """x, y and the fetched scalars of ``opts``' single program after
    ``iters`` iterations from init_state (fewer if it stops), on the CPU;
    under ``axis`` (an active tensor-parallel axis) with the operator
    sharded as ``solve`` shards it."""
    setup = to_square_form(preprocess(problem))
    layout = setup.layout
    M = build_linop(setup.A, setup.G, torch.float64, device="cpu",
                    force=None if opts.linop == "auto" else opts.linop)
    if axis is not None:
        M = shard_linop(M, axis)
    o = convert.operands_from_numpy(
        M=M, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
        norm_h=setup.norm_h, norm_c=setup.norm_c,
        obj_scale=setup.obj_scale * setup.rhs_scale, device="cpu")
    run, _, fetch = tsolver.make_chunk_runner(layout, opts, device="cpu")
    s = convert.state_from_numpy(tsolver.init_state(layout, opts, setup),
                                 "cpu")
    s = run(s, o, iters)
    return {"x": s.x.numpy(), "y": s.y.numpy(), "fetch": fetch(s)}


def tp_solve(mesh, seed, side, opts):
    """solve_sharded of a max-cut problem, and the collectives it made."""
    with tp_context(mesh) as axis:
        before = axis.collectives
        res = solve_sharded(maxcut(seed, side), mesh, Options(**opts))
    out = summary(res)
    out["collectives"] = axis.collectives - before
    return out


def tp_iterate(mesh, seed, side, iters, opts):
    """``program_iterate`` under the mesh's tensor-parallel axis."""
    with tp_context(mesh) as axis:
        o = Options(**opts).replace(tp_shards=axis.size)
        return program_iterate(maxcut(seed, side), o, iters, axis)


def tp_divergent(mesh, seed, side, opts):
    """solve_sharded where rank 1 solves a problem one edge weight apart:
    the message of the RankDivergence each rank raises."""
    rank = torch.distributed.get_rank()
    try:
        solve_sharded(maxcut(seed, side, 1e-6 if rank == 1 else 0.0), mesh,
                      Options(**opts))
    except RankDivergence as e:
        return str(e)
    return None


def batch(mesh, n, side, opts, projection="auto"):
    """solve_batch of max-cut instances 0..n-1 over the mesh's batch axis:
    (status, objval, iter) each, and the f32 race's length."""
    stats = BatchStats()
    res = solve_batch([maxcut(s, side) for s in range(n)], Options(**opts),
                      mesh=mesh, projection=projection, device="cpu",
                      stats=stats)
    return {"results": [(r.status, r.objval, r.iter) for r in res],
            "race_iters": stats.race_iters, "programs": stats.programs}


def diag_program(rhs: float):
    """min X_11 s.t. X_00 = rhs, X psd (2 x 2): feasible for rhs >= 0,
    infeasible (a dual ray) below."""
    opt = Optimizer()
    X = opt.add_psd_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, rhs)
    opt.set_objective({int(X[1, 1]): 1.0}, sense="min")
    return opt.build_problem()


def batch_declared(mesh, path):
    """solve_batch of a feasible and an infeasible program over the mesh's
    batch axis (the last rank owns the declared one) with
    ``checkpoint_path=path``: (status, certificate_found) each, and the
    checkpoint paths this rank's re-entries into solve were given."""
    from proxsdp_tpu_torch.parallel import batch as tbatch

    seen, real = [], tbatch.solve

    def spy(problem, options, **kw):
        seen.append(options.checkpoint_path)
        return real(problem, options, **kw)

    tbatch.solve = spy
    try:
        res = solve_batch([diag_program(1.0), diag_program(-1.0)], Options(
            hybrid_precision=False, max_iter=20_000, chunk_iters=256,
            checkpoint_path=path, checkpoint_freq=256), mesh=mesh,
            device="cpu")
    finally:
        tbatch.solve = real
    return {"results": [(r.status, r.certificate_found) for r in res],
            "seen": seen}


def batch_refused(mesh, n, side, batch_axis):
    """solve_batch of n instances over ``batch_axis``: the ValueError's
    message (None if it solved)."""
    try:
        solve_batch([maxcut(s, side) for s in range(n)],
                    Options(hybrid_precision=False), mesh=mesh,
                    batch_axis=batch_axis, device="cpu")
    except ValueError as e:
        return str(e)
    return None


JOBS = {f.__name__: f for f in (tp_solve, tp_iterate, tp_divergent, batch,
                                batch_declared, batch_refused)}


def run_jobs(mesh, jobs):
    """[JOBS[name](mesh, *args) for (name, args) in jobs] on this rank."""
    return [JOBS[name](mesh, *args) for name, args in jobs]


def one_rank_results(outs, job: int):
    """Job ``job``'s result on every rank of a ``spawn``."""
    return [out[job] for out in outs]


def all_equal(values) -> bool:
    first = values[0]
    for v in values[1:]:
        if isinstance(first, dict):
            if first.keys() != v.keys() or not all(
                    np.array_equal(first[k], v[k]) if isinstance(first[k], np.ndarray)
                    else first[k] == v[k] for k in first):
                return False
        elif first != v:
            return False
    return True
