"""Batched-instance solver (``proxsdp_tpu/parallel/batch.py``): many conic
problems of one geometry at once.

The JAX package ``vmap``s the single-instance PDHG iteration over a leading
instance axis and drives it with one ``while_loop`` whose predicate is
"any instance still running"; finished instances freeze under a mask.
Here the instance axis is written out:

* the state is the single-instance ``solver.State`` with axis 0 = instance
  on every field (scalars (B,), ring buffers (B, L), warm (B, side));
* ``_primal_step``, ``_linesearch`` and ``_dual_step`` are the batched
  forms, beside the single-instance ones: the update is K4's batched entry
  point (no symmetrisation in the packed-triangle layout), the projection
  is ``ops.cones.psd_projection_small_batch`` (K10 to the square, the
  batched Jacobi projection K9, K10 back), the products K1's batched entry
  point, the linesearch trials K2's;
* ``solver._residuals_and_gap`` (K3's batched entry point) and
  ``solver._control`` run on the batched state as they are;
* ``run_chunk`` reads one flag pair per iteration (any / all instances
  active) and freezes the inactive instances with ``torch.where`` over
  every field; a linesearch reads one "any active instance still
  searching" flag per trial.  Nothing loops over instances on the host.

Like the JAX driver this forces the dense-eigh projection
(``use_lanczos=False``, ``subspace_rank=0``) and runs, under the default
``Options()``, an f32 race with per-instance stall tracking, a hand-over
to f64 that restarts the step machinery of stalled or non-finite
instances, and an f64 final phase.  The blocks stay packed scaled
triangles (no ``to_square_form``).

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP
item: ``mesh=`` (multi-GPU, B14); the subspace batch mode
(``projection="subspace"``, or ``"auto"`` with B > 32 and a side with
16 < side // 2: ``_reseed_batch``, ``subspace_accept_always``);
per-instance operators (``ell_batched`` / ``dense_batched``); the
certificate re-entry of an instance that ends with status 5 or 6 (A4c).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .. import convert, kernels
from ..ops.cones import psd_projection_small_batch
from ..ops.linop import build_linop
from ..ops.tri import tri_len
from ..options import Options
from ..problem import ConeLayout, ConicProblem, preprocess
from ..result import STATUS_STRINGS, Result
from ..solver import (
    STATE_FIELDS,
    Operands,
    State,
    _at,
    _Budget,
    _cache_solution,
    _cast_state,
    _col,
    _control,
    _ieee_f32_products,
    _residuals_and_gap,
    _unsupported,
    init_state,
)


def _force_batch_options(opts: Options) -> Options:
    """The dense-eigh projection for every instance (batch.py:60-66)."""
    return opts.replace(use_lanczos=False, certificate_search=False,
                        subspace_rank=0)


def _check_batch(opts: Options, layout: ConeLayout) -> None:
    """Options and layouts outside the slice raise, naming the ROADMAP item."""
    if opts.tp_shards:
        _unsupported("tp_shards", "A12")
    if opts.checkpoint_path:
        _unsupported("checkpoint_path", "A10")
    if opts.equilibration or opts.equilibration_force:
        _unsupported("equilibration", "A6")
    if opts.block_equilibration is True:
        _unsupported("block_equilibration=True", "A6")
    if opts.linop == "coo":
        _unsupported("linop='coo'", "B2'")
    if opts.projection == "polar":
        _unsupported("projection='polar' in the batch driver",
                     "A11 (the batched polar projection)")
    if layout.soc_lens:
        _unsupported("SOC blocks in a batch", "A7 / B3'")
    if len(layout.sdp_sides) != 1:
        _unsupported("batched problems without exactly one PSD block "
                     "(multi-block, LPs)", "A7")


# ---------------------------------------------------------------------------
# Batched state and operands (batch.py:188-285)
# ---------------------------------------------------------------------------


def _same_constraints(s0, s1) -> bool:
    """True iff s1 carries the exact same stacked [A; G] as s0."""
    for X, Y in ((s0.A, s1.A), (s0.G, s1.G)):
        if sp.issparse(X) or sp.issparse(Y):
            if not (sp.issparse(X) and sp.issparse(Y)) or X.shape != Y.shape:
                return False
            D = sp.csr_matrix(X) - sp.csr_matrix(Y)
            if D.nnz and np.abs(D.data).max() != 0.0:
                return False
        elif not np.array_equal(np.asarray(X), np.asarray(Y)):
            return False
    return True


def _batch_operands(setups, dt, device, linop: str) -> Operands:
    """Operands of the sweep: one operator shared by every instance and
    per-instance b, h, c (B, .) and norms (B,) (batch.py:219-270).

    The shared operator is ELL whenever its tables build (``linop="auto"``):
    a batched product is then one K1 launch that reads B * nnz values,
    where the dense form reads the whole (p + m) x n matrix."""
    if not all(_same_constraints(setups[0], s) for s in setups[1:]):
        _unsupported("instances with different constraint matrices "
                     "(per-instance operators, ell_batched / dense_batched)",
                     "A11")
    s0 = setups[0]
    M = build_linop(s0.A, s0.G, dt, device=device,
                    force="ell" if linop == "auto" else linop)

    def rows(name):
        return torch.tensor(np.stack([np.asarray(getattr(s, name), np.float64)
                                      for s in setups]), dtype=dt, device=device)

    def scalars(vals):
        return torch.tensor(np.asarray(vals, np.float64), dtype=dt,
                            device=device)

    return Operands(
        M=M, b=rows("b"), h=rows("h"), c=rows("c"),
        norm_b=scalars([s.norm_b for s in setups]),
        norm_h=scalars([s.norm_h for s in setups]),
        norm_c=scalars([s.norm_c for s in setups]),
        obj_scale=scalars([s.obj_scale * s.rhs_scale for s in setups]),
    )


def _stack_states(layout, opts, setups, device) -> State:
    return convert.state_from_numpy(
        convert.stack_states([init_state(layout, opts, s) for s in setups]),
        device)


def _where_rows(mask, new: State, old: State) -> State:
    """Per instance: ``new`` where ``mask`` (B,) holds, else ``old``."""
    def pick(n, o):
        return torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)

    kw = {}
    for name in STATE_FIELDS:
        n, o = getattr(new, name), getattr(old, name)
        kw[name] = (tuple(pick(a, b) for a, b in zip(n, o)) if name == "warm"
                    else pick(n, o))
    return State(**kw)


@dataclasses.dataclass
class BatchStats:
    """What a ``solve_batch`` did, for benchmarks and logs: the f32 race's
    length in iterations (0 without it), the program's steps (each one
    iteration of every active instance) and the seconds of each phase."""

    race_iters: int = 0
    steps: int = 0
    race_seconds: float = 0.0
    final_seconds: float = 0.0


# ---------------------------------------------------------------------------
# The batched iteration (solver.py:306-490 under batch.py:141's vmap)
# ---------------------------------------------------------------------------


def _primal_step(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """x <- proj_K(x - tau*(M'y + c)); Mx <- M x, for every instance."""
    side = layout.sdp_sides[0]
    tl = tri_len(side)
    u = kernels.primal_update_batch(s.x, s.Mty, o.c, s.primal_step)
    n = u.shape[1]
    blocks, me, cur, warm = psd_projection_small_batch(
        u if n == tl else u[:, :tl].contiguous(), side, opts=opts)
    x = blocks if n == tl else torch.cat([blocks, u[:, tl:]], dim=1)
    return s.replace(
        x=x,
        Mx=o.M.matvec_batch(x),
        min_eig=me.to(s.min_eig.dtype).unsqueeze(1),
        current_rank=cur.unsqueeze(1),
        warm=(warm,),
        # the dense eigh ran for every block of side > 1 (used_full)
        proj_fallbacks=s.proj_fallbacks + 1 if side > 1 else s.proj_fallbacks,
    )


def _linesearch(s: State, o: Operands, layout: ConeLayout, opts: Options,
                active: torch.Tensor):
    """Malitsky-Pock backtracking with per-instance trials (the vmapped
    while_loop of solver.py:449-473): an instance that accepts keeps that
    trial's values while the others go on.  The host reads one flag per
    trial -- "an active instance is still searching"; the inactive ones
    are frozen by the caller whatever they computed."""
    p, m = layout.p, layout.m
    ps = s.primal_step * torch.sqrt(1.0 + s.theta)
    sqrt_beta = torch.sqrt(s.beta)
    done = None
    for _ in range(opts.max_linsearch_steps):
        th = ps / s.primal_step_old
        yt, dy = kernels.ls_dual_update_batch(
            s.y, s.Mx, s.Mx_old, o.b, o.h, s.y_old, s.beta * ps, th, p, m)
        mt = o.M.rmatvec_batch(yt)
        dM = kernels.sq_dist_batch(mt, s.Mty_old)
        ok = sqrt_beta * ps * torch.sqrt(dM) <= opts.delta * torch.sqrt(dy)
        if done is None:
            theta, y_temp, Mty = th, yt, mt
            ps = torch.where(ok, ps, ps * opts.linsearch_decay)
            done = ok
        else:
            run = ~done
            theta = torch.where(run, th, theta)
            y_temp = torch.where(_col(run), yt, y_temp)
            Mty = torch.where(_col(run), mt, Mty)
            ps = torch.where(run & ~ok, ps * opts.linsearch_decay, ps)
            done = done | ok
        if not bool(torch.any(active & ~done)):
            break
    return s.replace(y=y_temp, Mty=Mty, theta=theta, primal_step=ps,
                     primal_step_old=ps, dual_step=s.beta * ps)


def _dual_step(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """Fixed-step dual update (solver.py:484-490): K2 with theta = 1."""
    y_temp, _ = kernels.ls_dual_update_batch(
        s.y, s.Mx, s.Mx_old, o.b, o.h, s.y_old, s.dual_step,
        torch.ones_like(s.dual_step), layout.p, layout.m)
    return s.replace(y=y_temp, Mty=o.M.rmatvec_batch(y_temp),
                     primal_step_old=s.primal_step)


def make_batch_runner(layout: ConeLayout, opts: Options, *, device,
                      stats: BatchStats | None = None):
    """(run_chunk, fetch) of the batched program (batch.py:122-177).

    ``run_chunk(s, o, chunk_end)`` steps while any instance is active
    (status 0 and iter < chunk_end) and freezes the others, adding each
    step to ``stats.steps``; ``fetch(s)`` returns a (B, 7) array of
    [iter, status, gap, feas, prim_obj, dual_obj, sub_worst] per instance
    (one device-to-host copy)."""
    sides_arr = torch.tensor(layout.sdp_sides, dtype=torch.int32, device=device)

    def iteration(s: State, o: Operands, active: torch.Tensor) -> State:
        s = _primal_step(s, o, layout, opts)
        if opts.line_search_flag:
            s = _linesearch(s, o, layout, opts, active)
        else:
            s = _dual_step(s, o, layout, opts)
        s = _residuals_and_gap(s, o, layout, opts)
        return _control(s, o, layout, opts, sides_arr)

    def run_chunk(s: State, o: Operands, chunk_end: int) -> State:
        while True:
            active = (s.status == 0) & (s.iter < chunk_end)
            any_all = torch.stack([torch.any(active), torch.all(active)]).cpu()
            if not bool(any_all[0]):
                return s
            new = iteration(s, o, active)
            s = new if bool(any_all[1]) else _where_rows(active, new, s)
            if stats is not None:
                stats.steps += 1

    def fetch(s: State) -> np.ndarray:
        i = torch.remainder(s.iter - 1, s.buf_gap.shape[-1])
        ft = s.buf_gap.dtype
        return torch.stack([
            s.iter.to(ft), s.status.to(ft), _at(s.buf_gap, i),
            _at(s.buf_feas, i), _at(s.buf_prim_obj, i),
            _at(s.buf_dual_obj, i), s.sub_worst.to(ft),
        ], dim=-1).cpu().numpy()

    return run_chunk, fetch


# ---------------------------------------------------------------------------
# Host driver (batch.py:288-606)
# ---------------------------------------------------------------------------


def solve_batch(problems: Sequence[ConicProblem], options: Options | None = None,
                mesh=None, projection: str = "auto",
                *, device="cuda", stats: BatchStats | None = None,
                **kwargs) -> list[Result]:
    """Solve a batch of same-geometry problems; one Result per instance.

    With the default ``dtype="float64", hybrid_precision=True`` the sweep
    races in f32 until every instance has converged to
    ``hybrid_switch_factor * tol``, stopped, or stalled (no 1.2x
    improvement of max(gap, feas) over 3 consecutive chunks), then the
    whole batch is cast to f64 and finished by the f64 program.
    ``device`` defaults to the CUDA card; without one it raises (pass
    ``device="cpu"`` for the plain PyTorch path).  ``mesh`` (sharding
    over cards, with its ``batch_axis``) is ROADMAP B14.  A ``stats``
    object passed in is filled with what the solve did."""
    with _ieee_f32_products():
        return _solve_batch(problems, options, mesh, projection, device,
                            stats if stats is not None else BatchStats(),
                            kwargs)


def _solve_batch(problems, options, mesh, projection, device, stats, kwargs):
    cert_opts = (options or Options()).replace(**kwargs)
    opts = _force_batch_options(cert_opts)
    if mesh is not None:
        _unsupported("solve_batch(mesh=...) (instances sharded over cards)",
                     "B14")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "solve_batch: no CUDA card is available (torch.cuda.is_available()"
            " is false); pass device='cpu' for the plain PyTorch path")
    t0 = time.time()

    setups = [preprocess(p, scale_objective=opts.scale_objective,
                         scale_rhs=opts.scale_rhs) for p in problems]
    layout = setups[0].layout
    for s in setups[1:]:
        if s.layout != layout:
            raise ValueError("all batched problems must share one geometry")
    _check_batch(opts, layout)

    B = len(setups)
    if projection not in ("auto", "eigh", "subspace"):
        raise ValueError(f"unknown projection mode {projection!r}")
    want_sub = projection == "subspace" or (projection == "auto" and B > 32)
    if want_sub and any(16 < side // 2 for side in layout.sdp_sides):
        _unsupported(f"the subspace batch mode (projection={projection!r}, "
                     f"B = {B}, sides {layout.sdp_sides}: _reseed_batch, "
                     "subspace_accept_always)", "A11")

    hybrid = opts.dtype == "float64" and opts.hybrid_precision
    phase_opts = opts.replace(dtype="float32") if hybrid else opts
    phase_dt = torch.float32 if phase_opts.dtype == "float32" else torch.float64

    ops = _batch_operands(setups, phase_dt, device, opts.linop)
    states = _stack_states(layout, phase_opts, setups, device)
    tau0 = states.primal_step.cpu().numpy().astype(np.float64)
    run_chunk, fetch = make_batch_runner(layout, phase_opts, device=device,
                                            stats=stats)
    budget = _Budget(opts, bool(layout.sdp_sides or layout.soc_lens))
    # on-device convergence logic: the chunk only sets how often the host
    # looks (batch.py:420-424)
    chunk = opts.chunk_iters or (
        max(min(opts.log_freq, 1024), opts.convergence_check)
        if opts.log_verbose else 1024)

    def step(states, ops, running):
        iters_now = states.iter.cpu().numpy()
        k0 = int(iters_now[running].min()) if running.any() else int(
            iters_now.min())
        return run_chunk(states, ops, min(k0 + chunk, budget.max_iter))

    # ---- phase 1 (hybrid only): the f32 race, per-instance stall tracking
    if hybrid:
        t_race = time.time()
        F = opts.hybrid_switch_factor
        best = np.full(B, np.inf)
        stall = np.zeros(B, np.int64)
        ready = np.zeros(B, bool)
        while True:
            states = step(states, ops, ~ready)
            sc = fetch(states)
            iters = sc[:, 0].astype(int)
            status = sc[:, 1].astype(int)
            gap, feas = sc[:, 2], sc[:, 3]
            metric = np.maximum(gap, feas)
            improved = metric < best / 1.2
            best = np.where(improved, metric, best)
            stall = np.where(improved, 0, stall + 1)
            near = (gap <= F * opts.tol_gap) & (feas <= F * opts.tol_feasibility)
            ready |= (status != 0) | near | (stall >= 3) | (
                iters >= budget.max_iter)
            elapsed = time.time() - t0
            if opts.log_verbose:
                print(f"  [batch/f32] iter>={iters.min()} ready="
                      f"{int(ready.sum())}/{B} max_gap={np.nanmax(gap):.2e} "
                      f"t={elapsed:.1f}s")
            if ready.all() or elapsed >= budget.time_limit:
                break
        stats.race_iters = int(iters.max())

        # hand over: cast to f64, clear statuses; restart the step machinery
        # of stalled or non-finite instances (batch.py:477-542)
        sc = fetch(states)
        near_now = (sc[:, 2] <= F * opts.tol_gap) & (
            sc[:, 3] <= F * opts.tol_feasibility)
        bad = ((stall >= 3) & ~near_now) | ~np.isfinite(sc[:, 2:6]).all(axis=1)
        states = _cast_state(states, torch.float64)
        if bad.any():
            nan_rows = ~torch.isfinite(states.x).all(dim=1)
            if bool(nan_rows.any()):
                fresh = _stack_states(layout, opts, setups, device)
                states = _where_rows(nan_rows, fresh, states).replace(
                    iter=states.iter)
            badm = torch.tensor(bad, device=device)

            def rs(val, new):
                return torch.where(badm, torch.as_tensor(
                    new, dtype=torch.float64, device=device), val)

            states = states.replace(
                primal_step=rs(states.primal_step, tau0),
                primal_step_old=rs(states.primal_step_old, tau0),
                dual_step=rs(states.dual_step, tau0),
                theta=rs(states.theta, opts.initial_theta),
                beta=rs(states.beta, opts.initial_beta),
                adapt_level=rs(states.adapt_level, opts.initial_adapt_level),
                ada_count=torch.where(badm, torch.zeros_like(states.ada_count),
                                      states.ada_count),
            )
        ops = _batch_operands(setups, torch.float64, device, opts.linop)
        run_chunk, fetch = make_batch_runner(layout, opts, device=device,
                                                stats=stats)
        stats.race_seconds = time.time() - t_race

    # ---- final phase: the target dtype until every instance stops
    t_final = time.time()
    while True:
        running_now = states.status.cpu().numpy() == 0
        states = step(states, ops, running_now)
        sc = fetch(states)
        status = sc[:, 1].astype(int)
        iters = sc[:, 0].astype(int)
        elapsed = time.time() - t0
        running = status == 0
        if opts.log_verbose:
            print(f"  [batch] iter>={iters.min()} done={int((~running).sum())}"
                  f"/{B} max_gap="
                  f"{sc[running, 2].max() if running.any() else 0:.2e} "
                  f"t={elapsed:.1f}s")
        if not running.any():
            break
        if iters[running].min() >= budget.max_iter or elapsed >= budget.time_limit:
            break
    stats.final_seconds = time.time() - t_final

    # finalize per instance on the host (one transfer per field)
    states_np = convert.state_to_numpy(states)
    results = []
    for i in range(B):
        st = int(states_np["status"][i])
        if st == 0:
            st = 3 if int(states_np["iter"][i]) >= budget.max_iter else 2
        if st in (5, 6) and cert_opts.certificate_search:
            _unsupported(f"the certificate search of instance {i} (status "
                         f"{st}; pass certificate_search=False to return the "
                         "declaration)", "A4c (batched certificate re-entry)")
        results.append(_cache_solution(
            convert.index_state(states_np, i), setups[i], opts, t0,
            status=st, status_string=STATUS_STRINGS[st], square_form=False))
    return results
