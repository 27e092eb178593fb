"""Batched-instance solver (``proxsdp_tpu/parallel/batch.py``): many conic
problems of one geometry at once.

The JAX package ``vmap``s the single-instance PDHG iteration over a leading
instance axis and drives it with one ``while_loop`` whose predicate is
"any instance still running"; finished instances freeze under a mask.
Here the instance axis is written out:

* the state is the single-instance ``solver.State`` with axis 0 = instance
  on every field (scalars (B,), per-block min_eig and ranks (B, blocks),
  ring buffers (B, L), warm (B, side) or, in the subspace mode, (B, side,
  k) bases);
* ``_primal_step``, ``_linesearch`` and ``_dual_step`` are the batched
  forms, beside the single-instance ones, over any cone layout: the update
  is K4's batched entry point over the whole row (no symmetrisation in the
  packed-triangle layout), the products the operator's batched ones, the
  linesearch's trials one launch of K15b;
* the PSD blocks are projected as ``solver._primal_step`` projects them
  (``solver.block_plan``): same-side blocks for which the gating always
  takes the dense path are stacked over instances x blocks, one dense
  eigh; every other block goes through the JAX batch's engine for its side
  (``ops.cones.projection_kind``, the gating of cones.py:124-540):

  - the dense eigh (``ops.cones.psd_projection_small_batch``: K10 to the
    square, the batched Jacobi projection, K10 back), the batch's default
    (batch.py:60-66 forces it).  The Jacobi is K9 where one instance's
    matrix and rotations fit in a block's shared memory (side <= 118 in
    f64, 168 in f32) and K9L above (the same rotations, the working set in
    device memory);
  - in the subspace mode, for a block with 0 < k < side // 2,
    ``kernels.batched_subspace``, the accept-always Rayleigh-Ritz step
    (cones.py:427-510): K12 where one instance's working set fits in a
    block's shared memory and k <= 64, else K12L (its panels in device
    memory, k up to the largest bucket); the other blocks take K9 in the
    same step;
  - under ``Options(projection="polar")`` at sides >= ``polar_min_side``
    outside a group, the Newton-Schulz polar projection (cones.py:62-109,
    526-540; ``ops.cones.polar_psd_batch``: K10, the batched entry points
    of K5 and K6, K10 back).  It reports min_eig 0, keeps the warm vector
    and counts as no fallback; an instance whose result is not finite
    passes its X through with rank = side;
  - a lone side-1 block is clipped at 0;
* the SOC blocks of every instance are K13b (``kernels.
  soc_projection_batch``), with each instance's gap (B,) for the stop
  test; the free and LP coordinates keep the update's values;
* the operator is one shared by every instance -- ELL (K1's batched
  entry point), COO (K14b; K15b's COO form in the linesearch) or dense --
  or, where the instances' [A; G] differ, one per instance
  (``_batch_operands``): stacked ELL values over shared index tables (K1's
  and K15b's value stride) or a (B, p+m, n) stack of dense matrices (K16
  ``batched_gemv`` for M x, K15b's own per-instance M' y);
* ``solver._scalar_step`` (K3's batched entry point, then K20a, K19 and
  K20b's batch forms: a CTA an instance for the reductions, a warp an
  instance for the decisions) runs on the batched state as it is;
* ``run_chunk`` reads one flag pair per iteration (any / all instances
  active) and freezes the inactive instances in one launch of K21 over
  every field.  Nothing loops over instances on the host.

Like the JAX driver this runs, under the default ``Options()``, an f32
race with per-instance stall tracking, a hand-over to f64 that restarts
the step machinery of stalled or non-finite instances, and an f64 final
phase.  The blocks stay packed scaled triangles (no ``to_square_form``).
The projection is the dense eigh unless the subspace mode is on
(``projection="subspace"``, or ``"auto"`` with B > 32, for a layout with
a block of 16 < side // 2): then every iteration takes the accept-always
subspace step on those blocks, and between chunks the host reseeds the
bases of instances whose worst Ritz residual grew (``_reseed_batch``: an
exact host eigh of every subspace block), escalates the bucket with the
observed rank, or drops the batch to the eigh program when the rank
outgrows every subspace block's ``side // 2``.

An instance that ends with status 5 or 6 under ``certificate_search``
goes through the single-instance ``solve``, warm-started from its batch
iterate (through user space, so every PSD block reaches the square form
and the SOC blocks and the tail are carried), for its ray search.

``equilibration``, ``equilibration_force`` and ``block_equilibration``
are accepted and have no effect, as in the JAX batch driver: its
``preprocess`` call does not equilibrate and its operands carry no row
unscale (batch.py:257-269, 311-318).

``checkpoint_path`` writes no checkpoint in the batch loop, as in the
JAX batch driver: it rides in the options of the re-entry into ``solve``
for a declared instance (batch.py:591-603).  ``tp_shards`` splits no
block here: the batch's engines are batched kernels, and a ``tp_shards``
with no active tensor-parallel mesh is a plain solve in both packages.

``mesh=`` lays the instances over the mesh's ``batch_axis`` (the JAX
driver's ``shard_tree``, batch.py:291-297, 350-371): every rank of the
axis calls ``solve_batch`` with the same problem list and runs this
engine on its contiguous share of the instances, on its own device.  The
decisions that span instances -- each chunk's end (the least iteration
of the running instances), the race's ``ready.all()`` and stall test,
the hand-over, the subspace bucket escalation, ``running.any()``, the
iteration and time budgets -- are taken on the global per-instance
scalars: one all_gather of ``fetch``'s (B_r, 7) array a chunk (the
counterpart of the JAX driver's one ``any(active)`` reduction a chunk),
with rank 0's clock riding in it.  A bucket escalation adds a max over
the ranks' observed ranks.  Every rank returns all B Results in instance
order (an all_gather of the ranks' Results); only rank 0 prints, and a
declared instance's re-entry into ``solve`` writes a checkpoint only on
rank 0.  A batch that the axis size does not divide raises
``ValueError``, as the JAX driver's ``device_put`` does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Sequence

import numpy as np
import scipy.sparse as sp
import torch

from .. import convert, kernels
from .dist import Axis
from ..ops.cones import (polar_psd_batch, projection_kind,
                         psd_projection_small_batch)
from ..ops.linop import DenseOp, EllOp, build_linop
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
    _ieee_f32_products,
    _scalar_step,
    _sub_bucket,
    block_plan,
    init_state,
    solve,
)


def _force_batch_options(opts: Options) -> Options:
    """The dense-eigh projection for every instance (batch.py:60-66); the
    subspace mode turns its own step on after this."""
    return opts.replace(use_lanczos=False, certificate_search=False,
                        subspace_rank=0)


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
    """Operands of the sweep (batch.py:219-270): the operator and
    per-instance b, h, c (B, .) and norms (B,).  The operator follows the
    JAX driver's rule (batch.py:227-256):

    * "shared" when every instance has the same [A; G]: one operator;
    * else "ell_batched" when every instance's operator builds ELL tables
      and all their index tables are equal: the tables shared, the values
      stacked, (B, rows, width);
    * else "dense_batched": the (B, p+m, n) stack of dense matrices.

    Which form an instance's operator takes is the port's own policy,
    ELL first (``linop="auto"``: ELL whenever its rows and columns hold at
    most 32 entries, so a shared batched product is one K1 launch that
    reads B * nnz values, where the dense form reads the whole (p + m) x n
    matrix); the JAX package's CPU policy (linop.py:278-330) builds ELL
    only below density 0.02 on more than 2^16 entries, else dense.  So a
    small sweep the JAX driver stacks dense may share ELL tables here: the
    products round differently, the rule is the same.  ``linop="dense"``
    gives the dense forms.  ``operator_kind`` names the result."""
    force = "ell" if linop == "auto" else linop
    s0 = setups[0]
    if all(_same_constraints(s0, s) for s in setups[1:]):
        M = build_linop(s0.A, s0.G, dt, device=device, force=force)
    else:
        # each instance's operator on the host, then the stack on device
        ops = [build_linop(s.A, s.G, dt, device="cpu", force=force)
               for s in setups]
        o0 = ops[0]
        if all(isinstance(o, EllOp) and torch.equal(o.row_cols, o0.row_cols)
               and torch.equal(o.col_rows, o0.col_rows) for o in ops):
            M = EllOp(o0.row_cols, torch.stack([o.row_vals for o in ops]),
                      o0.col_rows, torch.stack([o.col_vals for o in ops]))
        else:
            M = DenseOp(torch.stack([
                build_linop(s.A, s.G, dt, device="cpu", force="dense").mat
                for s in setups]))
        M = M.to(device)

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


def operator_kind(M) -> str:
    """The JAX driver's m_kind of a batch operator: "shared",
    "ell_batched" or "dense_batched"."""
    if not M.batched:
        return "shared"
    return "ell_batched" if isinstance(M, EllOp) else "dense_batched"


def _stack_states(layout, opts, setups, device) -> State:
    return convert.state_from_numpy(
        convert.stack_states([init_state(layout, opts, s) for s in setups]),
        device)


def _where_rows(mask, new: State, old: State) -> State:
    """Per instance: ``new`` where ``mask`` (B,) holds, else ``old`` -- one
    launch of K21 (``kernels.freeze_rows``) over every field whose new and
    old are different tensors (a field that is one tensor in both is kept
    as it is)."""
    flat = []  # (field, new, old), warm's vectors one entry each
    for name in STATE_FIELDS:
        n, o = getattr(new, name), getattr(old, name)
        flat += ([(name, a, b) for a, b in zip(n, o)] if name == "warm"
                 else [(name, n, o)])
    todo = [(n, o) for _, n, o in flat if n is not o]
    outs = iter(kernels.freeze_rows(mask, [n for n, _ in todo],
                                    [o for _, o in todo]))
    kw = {"warm": []}
    for name, n, o in flat:
        v = n if n is o else next(outs)
        if name == "warm":
            kw["warm"].append(v)
        else:
            kw[name] = v
    kw["warm"] = tuple(kw["warm"])
    return State(**kw)


def _reseed_batch(states: State, layout: ConeLayout, k: int, mask, c_np,
                  opts: Options):
    """Host basis reseed of the subspace mode (batch.py:69-120): for each
    instance with ``mask``, the exact top-k eigenvectors (descending) of
    the PRE-projection matrix x - tau (M'y + c) of each subspace block --
    the matrix the projection acts on -- go into its warm basis, and its
    sub_worst is reset.  A basis of another k (the bucket escalated) is
    rebuilt for every instance.  Returns (states, r_max), r_max the
    largest rank (eigenvalues above tol_psd) seen.  NumPy on the host, as
    in the JAX package; one stacked eigh over the masked instances (the
    same LAPACK call per matrix as a loop: tests/test_torch_batch_subspace.py
    holds the two equal bit for bit)."""
    x = states.x.cpu().numpy().astype(np.float64)
    mty = states.Mty.cpu().numpy().astype(np.float64)
    tau = states.primal_step.cpu().numpy().astype(np.float64)
    pre = x - tau[:, None] * (mty + c_np)
    mask = np.asarray(mask, bool).copy()
    B = x.shape[0]
    r_max = 0
    warm = []
    for old, off, side in zip(states.warm, layout.sdp_offsets,
                              layout.sdp_sides):
        k_sub = int(min(k, side))
        if not 0 < k_sub < side // 2:
            warm.append(old)
            continue
        want = (B, side, k_sub)
        if tuple(old.shape) != want:
            mask[:] = True
            w_new = np.zeros(want)
        else:
            w_new = old.cpu().numpy().copy()
        gidx, in_scale, _, _ = kernels._maps(side)
        rows = np.nonzero(mask)[0]
        if rows.size:
            Xm = (pre[rows, off:off + tri_len(side)][:, gidx] * in_scale
                  ).reshape(-1, side, side)
            w_, V = np.linalg.eigh(Xm)
            r_max = max(r_max, int(np.sum(w_ > opts.tol_psd, axis=1).max()))
            w_new[rows] = V[:, :, -k_sub:][:, :, ::-1]
        warm.append(torch.tensor(w_new, dtype=states.x.dtype,
                                 device=states.x.device))
    m = torch.tensor(mask, device=states.x.device)
    return states.replace(
        warm=tuple(warm),
        sub_worst=torch.where(m, torch.zeros_like(states.sub_worst),
                              states.sub_worst)), r_max


@dataclasses.dataclass
class BatchStats:
    """What a ``solve_batch`` did, for benchmarks and logs: the f32 race's
    length in iterations (0 without it), the program's steps (each one
    iteration of every active instance), the seconds of each phase; in the
    subspace mode each host reseed (dtype, the smallest and largest
    iteration, k, instances masked, r_max) and each program the driver
    switched to (dtype, the smallest iteration, k; k = 0 the eigh
    program), the first one included."""

    race_iters: int = 0
    steps: int = 0
    race_seconds: float = 0.0
    final_seconds: float = 0.0
    reseeds: list = dataclasses.field(default_factory=list)
    programs: list = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# The batched iteration (solver.py:306-490 under batch.py:141's vmap)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _group_index(offsets: tuple, tl: int, device) -> torch.Tensor:
    """The columns of a group's blocks, block after block: x[:, index]
    is the (B, nb * tl) stack of the group's packed triangles."""
    return torch.tensor(np.concatenate([np.arange(off, off + tl)
                                        for off in offsets]), device=device)


def _primal_step(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """x <- proj_K(x - tau*(M'y + c)); Mx <- M x, for every instance, block
    by block over the layout (solver.py:306-432 under batch.py:141's
    vmap): K4b's update over the whole row; each group of same-side small
    blocks (``solver.block_plan``) stacked over instances x blocks, one
    dense eigh (K10, K9 or K9L, K10); every other PSD block through the
    engine ``projection_kind`` picks for it (the subspace step on K12 /
    K12L, polar on K5b / K6b, or the dense eigh); the SOC blocks on K13b
    with each instance's gap; the free and LP tail as the update left
    it."""
    u = kernels.primal_update_batch(s.x, s.Mty, o.c, s.primal_step)
    B, dev, dt = u.shape[0], u.device, u.dtype
    plan = block_plan(layout, opts)
    min_eig = list(s.min_eig.unbind(1))
    current_rank = list(s.current_rank.unbind(1))
    warm = list(s.warm)
    # the dense eigh or a subspace step's NaN guard ran (used_full), per
    # instance; None: no PSD block (solver.py:389-391, 408, 430)
    any_full = None
    sub_stats, sub_worst = s.sub_stats, s.sub_worst
    for side, blks in plan.groups:
        tl, nb = tri_len(side), len(blks)
        idx = _group_index(tuple(off for _, off in blks), tl, dev)
        proj, me_b, cur_b, warm_b = psd_projection_small_batch(
            u[:, idx].view(B * nb, tl), side, opts=opts)
        u[:, idx] = proj.view(B, nb * tl)
        me_b, cur_b = me_b.view(B, nb), cur_b.view(B, nb)
        warm_b = warm_b.view(B, nb, -1)
        for gi, (bi, _) in enumerate(blks):
            min_eig[bi] = me_b[:, gi].to(s.min_eig.dtype)
            current_rank[bi] = cur_b[:, gi]
            warm[bi] = warm_b[:, gi]  # a view: no kernel reads it
        any_full = torch.ones(B, dtype=torch.bool, device=dev)
    for bi, off, side in plan.singles:
        tl = tri_len(side)
        v = u[:, off : off + tl].contiguous()
        kind = projection_kind(side, opts, warm[bi].dim() == 3)
        full = torch.zeros(B, dtype=torch.bool, device=dev)
        stats = v.new_zeros(B, 3)
        if kind == "scalar":
            blk = torch.clamp_min(v, 0.0)
            me, cur = blk[:, 0], (blk[:, 0] > 0).to(torch.int32)
        elif kind == "subspace":
            # the driver turns the subspace mode on only with
            # subspace_accept_always (batch.py:340-345); the mixed mode is
            # an f64 program's subspace_mixed (cones.py:435); the NaN guard
            # counts as a fallback (cones.py:505-509)
            blk, me, cur, warm[bi], full, stats = kernels.batched_subspace(
                v, warm[bi], side, opts.tol_psd,
                bool(opts.subspace_mixed) and dt == torch.float64)
        elif kind == "polar":
            # min_eig 0 (the full path's semantics), the warm vector kept,
            # no fallback counted (cones.py:526-540)
            Xp, cur = polar_psd_batch(kernels.tri_to_square(v, side),
                                      aggressive=opts.polar_aggressive,
                                      polish=opts.polar_polish)
            blk, me = kernels.square_to_tri(Xp, side), v.new_zeros(B)
        else:  # the dense eigh (use_lanczos is off in a batch)
            blk, me, cur, warm[bi] = psd_projection_small_batch(v, side,
                                                                opts=opts)
            full = torch.ones(B, dtype=torch.bool, device=dev)
        u[:, off : off + tl] = blk
        min_eig[bi] = me.to(s.min_eig.dtype)
        current_rank[bi] = cur
        any_full = full if any_full is None else any_full | full
        sub_worst = torch.maximum(sub_worst, stats[:, 0])
        if bi == 0:
            sub_stats = stats
    if layout.soc_lens:
        a = layout.soc_offsets[0]
        b = a + sum(layout.soc_lens)
        u[:, a:b], max_soc_gap = kernels.soc_projection_batch(
            u[:, a:b], layout.soc_lens)
    else:
        max_soc_gap = torch.full((B,), -math.inf, dtype=dt, device=dev)
    return s.replace(
        x=u,
        Mx=o.M.matvec_batch(u),
        min_eig=torch.stack(min_eig, dim=1),
        current_rank=torch.stack(current_rank, dim=1).to(torch.int32),
        warm=tuple(warm),
        max_soc_gap=max_soc_gap,
        proj_fallbacks=(s.proj_fallbacks if any_full is None
                        else s.proj_fallbacks + any_full.to(torch.int32)),
        sub_stats=sub_stats,
        sub_worst=sub_worst,
    )


def _linesearch(s: State, o: Operands, layout: ConeLayout, opts: Options,
                active: torch.Tensor):
    """Malitsky-Pock backtracking with per-instance trials (the vmapped
    while_loop of solver.py:449-473), every trial of every active instance
    in one launch of kernel K15b (``kernels.linesearch_loop_batch``); an
    inactive instance keeps its values (the caller freezes it anyway)."""
    y, Mty, theta, ps, _ = kernels.linesearch_loop_batch(
        o.M, s.y, s.Mx, s.Mx_old, o.b, o.h, s.y_old, s.Mty, s.Mty_old,
        s.primal_step, s.primal_step_old, s.theta, s.beta, active, layout.p,
        layout.m, opts.delta, opts.linsearch_decay, opts.max_linsearch_steps)
    return s.replace(y=y, Mty=Mty, theta=theta, primal_step=ps,
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
    # the block sides (1,) without PSD blocks, as the single solve's and the
    # JAX batch's
    step = kernels.control_step(layout, opts, device)

    def iteration(s: State, o: Operands, active: torch.Tensor) -> State:
        s = _primal_step(s, o, layout, opts)
        if opts.line_search_flag:
            s = _linesearch(s, o, layout, opts, active)
        else:
            s = _dual_step(s, o, layout, opts)
        return _scalar_step(s, o, layout, opts, step)

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


def _search_declared(problems, results, cert_opts, dp, lo, hi, device):
    """The ray search of each declared instance (batch.py:591-604): the
    single-instance driver, warm-started from the batch iterate,
    re-declares and runs its certificate search.  On a mesh each rank
    searches the instances it owns, printing only on rank 0; with a
    ``checkpoint_path`` rank 0 alone runs every search, in instance
    order, so that one writer leaves the file the unsharded batch
    leaves, whichever rank owns the instance.  Returns all B Results."""
    re_opts = cert_opts.replace(tp_shards=0)
    declared = [i for i, r in enumerate(results) if r.status in (5, 6)]
    mine = declared
    if dp is not None:
        if re_opts.checkpoint_path:
            mine = declared if dp.rank == 0 else []
        else:
            mine = [i for i in declared if lo <= i < hi]
        if dp.rank != 0:
            re_opts = re_opts.replace(log_verbose=False, timer_verbose=False,
                                      timer_file=False)
    found = {i: solve(problems[i], re_opts, warm_start=results[i],
                      device=device) for i in mine}
    if dp is not None:
        if re_opts.checkpoint_path:
            found = dp.obj(found)
        else:
            found = {i: r for part in dp.gather_objects(found)
                     for i, r in part.items()}
    return [found.get(i, r) for i, r in enumerate(results)]


def solve_batch(problems: Sequence[ConicProblem], options: Options | None = None,
                mesh=None, batch_axis: str = "batch", projection: str = "auto",
                *, device="cuda", stats: BatchStats | None = None,
                **kwargs) -> list[Result]:
    """Solve a batch of same-geometry problems; one Result per instance.

    With the default ``dtype="float64", hybrid_precision=True`` the sweep
    races in f32 until every instance has converged to
    ``hybrid_switch_factor * tol``, stopped, or stalled (no 1.2x
    improvement of max(gap, feas) over 3 consecutive chunks), then the
    whole batch is cast to f64 and finished by the f64 program.
    ``device`` defaults to the CUDA card; without one it raises (pass
    ``device="cpu"`` for the plain PyTorch path).  ``mesh``: a
    ``DeviceMesh`` with an axis ``batch_axis`` over which the instances are
    split; every rank of it calls ``solve_batch`` with the same arguments
    (``device`` its own) and gets all B Results.  Only rank 0 prints, and
    with a ``checkpoint_path`` rank 0 runs the ray search of every
    declared instance, so that it alone writes the file, as the unsharded
    batch would.  A ``stats`` object passed in is filled with what the
    solve did (``steps``: this rank's)."""
    with _ieee_f32_products():
        return _solve_batch(problems, options, mesh, batch_axis, projection,
                            device, stats if stats is not None else BatchStats(),
                            kwargs)


def _solve_batch(problems, options, mesh, batch_axis, projection, device,
                 stats, kwargs):
    cert_opts = (options or Options()).replace(**kwargs)
    opts = _force_batch_options(cert_opts)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "solve_batch: no CUDA card is available (torch.cuda.is_available()"
            " is false); pass device='cpu' for the plain PyTorch path")
    B = len(problems)
    # the instances [lo, hi) of this rank (all of them off a mesh)
    dp = None if mesh is None else Axis(mesh, batch_axis)
    lo, hi = 0, B
    if dp is not None:
        if B % dp.size:
            raise ValueError(
                f"solve_batch: a batch of {B} instances does not divide over "
                f"the {dp.size} ranks of mesh axis {batch_axis!r}")
        lo, hi = dp.span(B)
    verbose = opts.log_verbose and (dp is None or dp.rank == 0)
    t0 = time.time() if dp is None else dp.now()

    setups_all = [preprocess(p, scale_objective=opts.scale_objective,
                             scale_rhs=opts.scale_rhs) for p in problems]
    layout = setups_all[0].layout
    for s in setups_all[1:]:
        if s.layout != layout:
            raise ValueError("all batched problems must share one geometry")
    setups = setups_all[lo:hi]

    hybrid = opts.dtype == "float64" and opts.hybrid_precision
    phase_opts = opts.replace(dtype="float32") if hybrid else opts
    phase_dt = torch.float32 if phase_opts.dtype == "float32" else torch.float64

    # the subspace mode (batch.py:328-345): the accept-always subspace step
    # every iteration, host reseeds between chunks
    if projection not in ("auto", "eigh", "subspace"):
        raise ValueError(f"unknown projection mode {projection!r}")
    sub_k = 0
    want_sub = projection == "subspace" or (projection == "auto" and B > 32)
    if want_sub and any(16 < side // 2 for side in layout.sdp_sides):
        sub_k = 16  # the starting bucket; reseeds escalate it
        phase_opts = phase_opts.replace(subspace_rank=sub_k,
                                        subspace_accept_always=True)
    c_np = np.stack([np.asarray(s.c, np.float64) for s in setups])

    ops = _batch_operands(setups, phase_dt, device, opts.linop)
    states = _stack_states(layout, phase_opts, setups, device)
    tau0 = states.primal_step.cpu().numpy().astype(np.float64)
    budget = _Budget(opts, bool(layout.sdp_sides or layout.soc_lens))

    def gather(sc_local):
        """(the (B, 7) scalars of every instance, seconds since t0 on rank
        0's clock) from this rank's fetch: one all_gather on a mesh."""
        if dp is None:
            return sc_local, time.time() - t0
        row = np.full((sc_local.shape[0], 1), time.time() - t0)
        part = torch.tensor(np.hstack([sc_local.astype(np.float64), row]),
                            device=dp.host_device())
        allsc = dp.all_gather_rows(part, B).cpu().numpy()
        return allsc[:, :-1], float(allsc[0, -1])

    def runner(it_min, run_opts):
        stats.programs.append((run_opts.dtype, int(it_min),
                               run_opts.subspace_rank))
        return make_batch_runner(layout, run_opts, device=device, stats=stats)

    def reseed(states, mask, iters):
        """_reseed_batch of the instances of ``mask`` (B,) on their ranks;
        (states, the largest rank observed on any rank)."""
        states, r_max = _reseed_batch(states, layout, sub_k, mask[lo:hi],
                                      c_np, opts)
        if dp is not None:
            r_max = int(dp.max(r_max))
        stats.reseeds.append((str(states.x.dtype).removeprefix("torch."),
                              int(iters.min()), int(iters.max()), sub_k,
                              int(np.sum(mask)), r_max))
        return states, r_max

    def maybe_reseed(states, sc, running, base_opts):
        """Host basis upkeep of the subspace mode (batch.py:377-411):
        (states, a new runner when the bucket escalated or the batch
        dropped to the eigh program, else None)."""
        nonlocal sub_k
        if not sub_k:
            return states, None
        need = running & (sc[:, 6] > max(10 * opts.subspace_tol, 1e-7))
        if not need.any():
            return states, None
        states, r_max = reseed(states, need, sc[:, 0])
        k2 = _sub_bucket(r_max + opts.polish_subspace_guard)
        if k2 == sub_k:
            return states, None
        if k2 == 0 or not any(k2 < side // 2 for side in layout.sdp_sides):
            # the rank outgrew every bucket: the eigh program, warm = the
            # leading column of each basis
            sub_k = 0
            new_opts = base_opts.replace(subspace_rank=0,
                                         subspace_accept_always=False)
            states = states.replace(warm=tuple(
                w[..., 0].contiguous() if w.dim() == 3 else w
                for w in states.warm))
        else:
            # escalation: every basis is rebuilt at the new k
            sub_k = k2
            new_opts = base_opts.replace(subspace_rank=k2)
            states, _ = reseed(states, np.ones(B, bool), sc[:, 0])
        return states, runner(sc[:, 0].min(), new_opts)

    run_chunk, fetch = runner(0, phase_opts)
    # on-device convergence logic: the chunk only sets how often the host
    # looks (batch.py:420-424)
    chunk = opts.chunk_iters or (
        max(min(opts.log_freq, 1024), opts.convergence_check)
        if opts.log_verbose else 1024)
    # the subspace mode starts on random bases (the cold pre-projection
    # matrix is 0): the first chunk of a phase stops at 128 iterations so
    # the first reseed comes early (batch.py:426-437)
    first_chunk = {"todo": bool(sub_k)}

    def step(states, ops, running, iters):
        """One chunk of every rank's running instances, to the least
        iteration of the running instances (of all, if none runs) plus a
        chunk."""
        k0 = int(iters[running].min()) if running.any() else int(iters.min())
        n = chunk
        if first_chunk["todo"]:
            first_chunk["todo"] = False
            n = min(chunk, 128)
        return run_chunk(states, ops, min(k0 + n, budget.max_iter))

    iters = np.zeros(B)  # every instance starts at iteration 0
    # ---- phase 1 (hybrid only): the f32 race, per-instance stall tracking
    if hybrid:
        t_race = time.time()
        F = opts.hybrid_switch_factor
        best = np.full(B, np.inf)
        stall = np.zeros(B, np.int64)
        ready = np.zeros(B, bool)
        while True:
            states = step(states, ops, ~ready, iters)
            sc, elapsed = gather(fetch(states))
            iters = sc[:, 0].astype(int)
            status = sc[:, 1].astype(int)
            states, new_runner = maybe_reseed(states, sc, ~ready, phase_opts)
            if new_runner is not None:
                run_chunk, fetch = new_runner
            gap, feas = sc[:, 2], sc[:, 3]
            metric = np.maximum(gap, feas)
            improved = metric < best / 1.2
            best = np.where(improved, metric, best)
            stall = np.where(improved, 0, stall + 1)
            near = (gap <= F * opts.tol_gap) & (feas <= F * opts.tol_feasibility)
            ready |= (status != 0) | near | (stall >= 3) | (
                iters >= budget.max_iter)
            if verbose:
                print(f"  [batch/f32] iter>={iters.min()} ready="
                      f"{int(ready.sum())}/{B} max_gap={np.nanmax(gap):.2e} "
                      f"t={elapsed:.1f}s")
            if ready.all() or elapsed >= budget.time_limit:
                break
        stats.race_iters = int(iters.max())

        # hand over: cast to f64, clear statuses; restart the step machinery
        # of stalled or non-finite instances (batch.py:477-542)
        sc, _ = gather(fetch(states))
        near_now = (sc[:, 2] <= F * opts.tol_gap) & (
            sc[:, 3] <= F * opts.tol_feasibility)
        bad = (((stall >= 3) & ~near_now)
               | ~np.isfinite(sc[:, 2:6]).all(axis=1))[lo:hi]
        states = _cast_state(states, torch.float64)
        if bad.any():
            nan_rows = ~torch.isfinite(states.x).all(dim=1)
            if bool(nan_rows.any()):
                fresh = _stack_states(layout, opts, setups, device)
                if sub_k:
                    # the fresh states carry warm vectors; the subspace
                    # phase below reseeds every basis anyway
                    fresh = fresh.replace(warm=states.warm)
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
        phase_opts = opts
        if sub_k:
            # an f64 subspace phase: re-estimate the bucket from the
            # current iterates and seed exact bases first (batch.py:523-541)
            states, r_max = reseed(states, np.ones(B, bool), iters)
            k2 = _sub_bucket(r_max + opts.polish_subspace_guard)
            if k2 and k2 != sub_k and any(k2 < side // 2
                                          for side in layout.sdp_sides):
                sub_k = k2
                states, _ = reseed(states, np.ones(B, bool), iters)
            phase_opts = opts.replace(subspace_rank=sub_k,
                                      subspace_accept_always=True)
        run_chunk, fetch = runner(iters.min(), phase_opts)
        stats.race_seconds = time.time() - t_race

    # ---- final phase: the target dtype until every instance stops (the
    # hand-over cleared every status)
    t_final = time.time()
    if not hybrid:
        first_chunk["todo"] = bool(sub_k)
    running = np.ones(B, bool)
    while True:
        states = step(states, ops, running, iters)
        sc, elapsed = gather(fetch(states))
        status = sc[:, 1].astype(int)
        iters = sc[:, 0].astype(int)
        running = status == 0
        states, new_runner = maybe_reseed(states, sc, running, phase_opts)
        if new_runner is not None:
            run_chunk, fetch = new_runner
        if verbose:
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
    for i in range(hi - lo):
        st = int(states_np["status"][i])
        if st == 0:
            st = 3 if int(states_np["iter"][i]) >= budget.max_iter else 2
        results.append(_cache_solution(
            convert.index_state(states_np, i), setups[i], opts, t0,
            status=st, status_string=STATUS_STRINGS[st], square_form=False))
    if dp is not None:
        results = [r for part in dp.gather_objects(results) for r in part]
    if cert_opts.certificate_search:
        results = _search_declared(problems, results, cert_opts, dp, lo, hi,
                                   device)
    return results
