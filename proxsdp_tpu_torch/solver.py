"""PDHG (Chambolle-Pock) solver core -- the port of ``proxsdp_tpu/solver.py``.

PSD blocks (any number and sides) in the square-form layout (the
default) or as packed scaled triangles (``square_form=False``), SOC
blocks, free and LP coordinates with equality and inequality rows, in f64
or f32; per iteration

1. ``_primal_step``: kernel K4 (the update, and in the square layout the
   symmetrisation of every block), the PSD projection of each block
   (``ops.cones``: same-side small blocks grouped into one batched eigh,
   kernel K9 on the card; each other block by dense eigh, the polar
   projection on K5/K6, the subspace step on K7/K8 with a polar or dense
   fallback, its sign-based body on K7/K17, its accept-always form on K12,
   or Lanczos on K11; a packed block unpacked and packed again by K10),
   the SOC projection of every SOC block (kernel K13), then ``M x``
   (kernel K1 for ELL);
2. ``_linesearch``: the Malitsky-Pock trials (K2's dual update, M'y, the
   accept test), at most ``max_linsearch_steps`` of them, all in one
   launch of kernel K15;
3. ``_residuals_and_gap``: kernel K3's nine f64 reductions, the scalar
   formulas in f64, a cast to the program's dtype at the ring writes;
4. ``_control``: the branch-free scalar control with adaptive
   restart-to-average, plain torch on 0-d device tensors (no sync).

The iteration is plain functions on a ``State`` dataclass of tensors.
``solve`` is the host driver (solver.py:1209-2357): Ruiz or block
equilibration and the ``block_equilibration="auto"`` probe, warm starts,
checkpoints and ``resume_from`` (``utils/checkpoint.py``, the JAX
package's format), and under the default ``Options()`` the hybrid f32
race -> f64 polish with its subspace entries, watchdog and logging;
``hybrid_precision=False`` one program; after a status 5 or 6 the
certificate search (the ray search on the zeroed operands, its deadlines,
the resume after a failed search and the demotion of an unproven
declaration).  Under ``parallel.sharded.solve_sharded`` (``tp_shards >
0`` with an active mesh) the same driver runs on every rank of the
tensor-parallel axis: the operator sharded (``ops.linop.shard_linop``),
the linesearch's trials on K2 and the sharded M' y, every host decision
and clock reading rank 0's, only rank 0 printing or writing checkpoints,
and the ranks' iterates checked against each other at the end.
``tp_shards > 0`` with no active mesh is a plain solve, as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from . import convert, kernels
from .equilibration import block_equilibrate_host, equilibrate_host
from .ops.cones import (
    projection_kind,
    psd_projection_block,
    psd_projection_small_batch,
)
from .ops.linop import build_linop, shard_linop, stack_vertical
from .options import Options
from .parallel.dist import RankDivergence
from .parallel.sharded import current_tp
from .problem import (
    ConeLayout,
    ConicProblem,
    SetupProblem,
    preprocess,
    square_embed_matrix,
    to_square_form,
)
from .result import STATUS_STRINGS, Result
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.vech import ivec, offdiag_mask_tri, sympackedlen, tri_ij


@dataclasses.dataclass
class Operands:
    """Device problem data.  ``obj_scale`` is SetupProblem.obj_scale *
    rhs_scale (solver.py:1307); ``row_unscale`` the (p + m,) 1/E of an
    equilibrated problem, which puts the feasibility residuals in user
    units (solver.py:66-71, 1308-1312), or None (no scaling); the chunk
    end is an argument of the chunk runner, not a field."""

    M: nn.Module  # DenseOp | EllOp for [A; G]
    b: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    norm_b: torch.Tensor  # 0-d
    norm_h: torch.Tensor
    norm_c: torch.Tensor
    obj_scale: torch.Tensor
    row_unscale: torch.Tensor | None = None


@dataclasses.dataclass
class State:
    """Solver state, field for field ``proxsdp_tpu.solver.State``
    (solver.py:74-151): vectors, 0-d scalars, i32 counters, and ``warm`` a
    tuple with one vector per PSD block."""

    x: torch.Tensor
    x_old: torch.Tensor
    y: torch.Tensor
    y_old: torch.Tensor
    Mx: torch.Tensor
    Mx_old: torch.Tensor
    Mty: torch.Tensor
    Mty_old: torch.Tensor
    primal_step: torch.Tensor
    primal_step_old: torch.Tensor
    dual_step: torch.Tensor
    theta: torch.Tensor
    beta: torch.Tensor
    adapt_level: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    rank_update: torch.Tensor
    update_cont: torch.Tensor
    ada_count: torch.Tensor
    target_rank: torch.Tensor
    current_rank: torch.Tensor
    min_eig: torch.Tensor
    buf_gap: torch.Tensor
    buf_prim_obj: torch.Tensor
    buf_dual_obj: torch.Tensor
    buf_feas: torch.Tensor
    buf_pres: torch.Tensor
    buf_dres: torch.Tensor
    buf_comb: torch.Tensor
    equa_feas: torch.Tensor
    ineq_feas: torch.Tensor
    max_soc_gap: torch.Tensor
    warm: tuple
    cert_kind: torch.Tensor
    cert_wait_until: torch.Tensor
    infeas_block_until: torch.Tensor
    opt_block_until: torch.Tensor
    avg_x: torch.Tensor
    avg_y: torch.Tensor
    avg_Mx: torch.Tensor
    avg_Mty: torch.Tensor
    avg_w: torch.Tensor
    last_restart_iter: torch.Tensor
    last_restart_gap: torch.Tensor
    proj_fallbacks: torch.Tensor
    sub_stats: torch.Tensor
    sub_worst: torch.Tensor

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(State))


# ---------------------------------------------------------------------------
# Host-side initial state (solver.py:158-290, NumPy)
# ---------------------------------------------------------------------------


def init_state(layout: ConeLayout, opts: Options, setup: SetupProblem,
               warm: tuple | None = None) -> dict:
    """Initial solver state as a dict of NumPy arrays (solver.py:158-278)
    in ``opts.dtype``, with an orthonormal (side, k) start basis for each
    block of a subspace program; ``convert.state_from_numpy`` moves it to
    a device.  ``warm``: None (cold start) or (x0, y0) in solver space;
    a warm start seeds the old iterates with it too."""
    dtype = np.float64 if opts.dtype == "float64" else np.float32
    n, pm = layout.n, layout.p + layout.m
    nb = max(len(layout.sdp_sides), 1)
    L = 2 * opts.convergence_window

    def z(*s):
        return np.zeros(s, dtype)

    M_host = stack_vertical(setup.A, setup.G)
    if opts.approx_norm:
        if hasattr(M_host, "multiply"):  # scipy sparse
            sn = float(np.sqrt(M_host.multiply(M_host).sum()))
        else:
            sn = float(np.linalg.norm(M_host))
    else:
        sn = _power_norm_host(M_host, n, opts.power_iters)
    if sn < 1e-10:
        sn = 1.0
    step = 1.0 / sn

    if warm is not None:
        x0 = np.asarray(warm[0], dtype=dtype)
        y0 = np.asarray(warm[1], dtype=dtype)
    else:
        x0 = (step * setup.c).astype(dtype) if opts.advanced_initialization else z(n)
        y0 = z(pm)
    Mx0 = np.asarray(M_host @ x0, dtype=dtype).ravel() if pm else z(pm)
    Mty0 = (np.asarray(M_host.T @ y0, dtype=dtype).ravel()
            if warm is not None and pm else z(n))
    cold = warm is None

    rng = np.random.RandomState(opts.eigsolver_resid_seed)
    warm_vecs = []
    for side in layout.sdp_sides:
        k_sub = int(min(opts.subspace_rank, side))
        if 0 < k_sub < side // 2:
            Q, _ = np.linalg.qr(rng.randn(side, k_sub))
            warm_vecs.append(Q.astype(dtype))
        else:
            v = rng.randn(side)
            v /= max(np.linalg.norm(v), 1e-12)
            warm_vecs.append(v.astype(dtype))
    if not layout.sdp_sides:
        warm_vecs.append(z(1))

    adaptive = opts.restart == "adaptive"
    return dict(
        x=x0,
        x_old=z(n) if cold else x0.copy(),
        y=y0,
        y_old=y0.copy(),
        Mx=Mx0,
        Mx_old=z(pm) if cold else Mx0.copy(),
        Mty=Mty0,
        Mty_old=Mty0.copy(),
        primal_step=dtype(step),
        primal_step_old=dtype(step),
        dual_step=dtype(step),
        theta=dtype(opts.initial_theta),
        beta=dtype(opts.initial_beta),
        adapt_level=dtype(opts.initial_adapt_level),
        iter=np.int32(0),
        status=np.int32(0),
        rank_update=np.int32(0),
        update_cont=np.int32(0),
        ada_count=np.int32(0),
        target_rank=np.full((nb,), 2, np.int32),
        current_rank=np.full((nb,), 2, np.int32),
        min_eig=z(nb),
        buf_gap=z(L),
        buf_prim_obj=z(L),
        buf_dual_obj=z(L),
        buf_feas=z(L),
        buf_pres=z(L),
        buf_dres=z(L),
        buf_comb=z(L),
        equa_feas=dtype(0.0),
        ineq_feas=dtype(0.0),
        max_soc_gap=dtype(-np.inf),
        warm=tuple(warm_vecs),
        cert_kind=np.int32(0),
        cert_wait_until=np.int32(0),
        infeas_block_until=np.int32(0),
        opt_block_until=np.int32(0),
        avg_x=z(n) if adaptive else z(0),
        avg_y=z(pm) if adaptive else z(0),
        avg_Mx=z(pm) if adaptive else z(0),
        avg_Mty=z(n) if adaptive else z(0),
        avg_w=dtype(0.0),
        last_restart_iter=np.int32(0),
        last_restart_gap=dtype(np.inf),
        proj_fallbacks=np.int32(0),
        sub_stats=np.zeros(3, dtype),
        sub_worst=dtype(0.0),
    )


def _power_norm_host(M, n, iters):
    """Spectral norm via host-side power iteration on M'M (deterministic)."""
    v = np.ones(n) / np.sqrt(n)
    for _ in range(iters):
        w = M.T @ (M @ v)
        nw = np.linalg.norm(w)
        if nw < 1e-30:
            return 0.0
        v = np.asarray(w).ravel() / nw
    return float(np.linalg.norm(M @ v))


# ---------------------------------------------------------------------------
# The iteration
# ---------------------------------------------------------------------------


# The scalar steps (_residuals_and_gap, _control) also run on a batched
# State (parallel/batch.py): a leading instance axis on every field, the
# scalars (B,) and the ring buffers (B, L).  These helpers take either; on
# the single-instance State they issue the same operations as before.


def _at(buf, i):
    """buf[..., i] for an integer tensor i (0-d, or (B,) for (B, L)
    buffers), without a host sync."""
    if i.dim() == 0:
        return buf.index_select(0, i.reshape(1).long())[0]
    return torch.gather(buf, -1, i.long().unsqueeze(-1)).squeeze(-1)


def _set(buf, i, v):
    if i.dim() == 0:
        return buf.index_copy(0, i.reshape(1).long(), v.reshape(1))
    return buf.scatter(-1, i.long().unsqueeze(-1), v.unsqueeze(-1))


def _col(v):
    """A scalar per instance as a column against (B, n) rows; a 0-d
    scalar becomes a 1-element vector (the same broadcast)."""
    return v.unsqueeze(-1)


def _dot(a, b):
    return torch.dot(a, b) if a.dim() == 1 else torch.sum(a * b, dim=-1)


def _max_abs_cyclic_diff(buf):
    """max_i |v[i] - v[i-1]| over the cyclic buffer (structs.jl:14-20)."""
    return torch.amax(torch.abs(buf - torch.roll(buf, 1, -1)), -1)


class BlockPlan(NamedTuple):
    """How ``_primal_step`` projects the PSD blocks (solver.py:343-368):
    ``groups`` [(side, [(block, offset)])] of same-side small blocks, each
    group one batched dense eigh (kernel K9 on the card); ``singles``
    [(block, offset, side)] projected one at a time."""

    groups: list
    singles: list


@functools.lru_cache(maxsize=64)
def _block_plan(layout: ConeLayout, subspace_rank: int, min_size_krylov: int,
                full_eig_max_side: int) -> BlockPlan:
    def grouped(side: int) -> bool:
        # only where the gating always takes the dense full path
        k_sub = int(min(subspace_rank, side))
        return (side <= min_size_krylov and side <= full_eig_max_side
                and not 0 < k_sub < side // 2)

    by_side: dict = {}
    singles = []
    for bi, (off, side) in enumerate(zip(layout.sdp_offsets, layout.sdp_sides)):
        if grouped(side):
            by_side.setdefault(side, []).append((bi, off))
        else:
            singles.append((bi, off, side))
    # groups of one gain nothing: back to the single path
    for side in [sd for sd, blks in by_side.items() if len(blks) < 2]:
        singles += [(bi, off, side) for bi, off in by_side.pop(side)]
    return BlockPlan(sorted(by_side.items()), sorted(singles))


def block_plan(layout: ConeLayout, opts: Options) -> BlockPlan:
    return _block_plan(layout, opts.subspace_rank, opts.min_size_krylov_eigs,
                       opts.full_eig_max_side)


def _primal_step(s: State, o: Operands, layout: ConeLayout, opts: Options,
                 k: int, target_ranks: tuple | None):
    """x <- proj_K(x - tau*(M'y + c)); Mx <- M x (pdhg.jl:611-637,
    solver.py:306-433).

    ``k`` is the iteration count before the step (the host knows it): the
    subspace program's forced reseed pulse is a host flag.
    ``target_ranks`` holds each block's target rank as a host int where
    its projection is Lanczos (the one branch that uses it), else None."""
    sides = layout.sdp_sides
    square = layout.square_form
    # the packed layout symmetrises nothing: tri_to_square builds each
    # block symmetric (cones.py:174)
    u = kernels.primal_update_sym(s.x, s.Mty, o.c, s.primal_step,
                                  sides if square else ())
    # relative-inexactness budget of the subspace test: the latest combined
    # PPA residual, clamped (solver.py:315-325); 0 before the first one
    accept_tol = None
    force_full = False
    if opts.subspace_rank > 0:
        if opts.subspace_rel_accept > 0:
            comb_prev = torch.abs(s.buf_comb[(k - 1) % s.buf_comb.shape[0]])
            accept_tol = torch.clamp_max(opts.subspace_rel_accept * comb_prev,
                                         opts.subspace_accept_cap)
        freq = opts.subspace_reseed_freq
        force_full = freq > 0 and k % freq == freq - 1
    if 0 < opts.full_eig_freq and opts.full_eig_len > 0:
        force_full = force_full or k % opts.full_eig_freq < opts.full_eig_len

    plan = block_plan(layout, opts)
    lens = layout.sdp_blk_lens
    nb = len(sides)
    blocks = [None] * nb  # projected flat blocks
    min_eig = list(s.min_eig.unbind(0))
    current_rank = list(s.current_rank.unbind(0))
    warm = list(s.warm)
    # host bool, or a 0-d device bool from a NaN guard (no host read)
    any_full = False
    sub_stats, sub_worst = s.sub_stats, s.sub_worst
    for side, blks in plan.groups:
        tl = lens[blks[0][0]]
        stacked = torch.stack([u[off : off + tl] for _, off in blks])
        proj, me_b, cur_b, warm_b = psd_projection_small_batch(
            stacked, side, opts=opts)
        for gi, (bi, _) in enumerate(blks):
            blocks[bi] = proj[gi]
            min_eig[bi] = me_b[gi].to(s.min_eig.dtype)
            current_rank[bi] = cur_b[gi]
            warm[bi] = warm_b[gi]
        any_full = True  # the dense eigh ran (the full path's used_full)
    for bi, off, side in plan.singles:
        tr = target_ranks[bi] if target_ranks is not None else None
        v = u[off : off + lens[bi]]
        res = psd_projection_block(v.view(side, side) if square else v,
                                   s.warm[bi], opts=opts,
                                   accept_tol=accept_tol,
                                   force_full=force_full, target_rank=tr)
        blocks[bi] = res.block.reshape(-1)
        min_eig[bi] = res.min_eig.to(s.min_eig.dtype)
        current_rank[bi] = res.current_rank
        warm[bi] = res.warm
        any_full = _any(any_full, res.used_full)
        sub_worst = torch.maximum(sub_worst, res.sub_stats[0])
        if bi == 0:
            sub_stats = res.sub_stats
    max_soc_gap = torch.full((), -math.inf, dtype=u.dtype, device=u.device)
    pieces = blocks
    end = sum(lens)
    if layout.soc_lens:
        soc_end = end + sum(layout.soc_lens)
        proj, max_soc_gap = kernels.soc_projection(u[end:soc_end],
                                                   layout.soc_lens)
        pieces = pieces + [proj]
        end = soc_end
    x = torch.cat(pieces + [u[end:]]) if pieces else u
    if isinstance(any_full, torch.Tensor):
        proj_fallbacks = s.proj_fallbacks + any_full.to(torch.int32)
    else:
        proj_fallbacks = s.proj_fallbacks + 1 if any_full else s.proj_fallbacks
    return s.replace(
        x=x,
        Mx=o.M.matvec(x),
        min_eig=torch.stack(min_eig),
        current_rank=torch.stack(current_rank).to(torch.int32),
        warm=tuple(warm),
        max_soc_gap=max_soc_gap,
        proj_fallbacks=proj_fallbacks,
        sub_stats=sub_stats,
        sub_worst=sub_worst,
    )


def _any(a, b):
    """a or b for host bools and 0-d device bools, with no host read."""
    if a is True or b is True:
        return True
    if a is False:
        return b
    if b is False:
        return a
    return a | b


def _linesearch(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """Malitsky-Pock backtracking dual step (pdhg.jl:532-582): every trial
    in one launch of kernel K15 (``kernels.linesearch_loop``).  K15 reads
    the whole M' and cannot span ranks: under tensor parallelism the trials
    run the sequence it is held to -- K2, the sharded M' y, K2's sq_dist
    -- with rank 0's accept decision a trial."""
    args = (o.M, s.y, s.Mx, s.Mx_old, o.b, o.h, s.y_old, s.Mty_old,
            s.primal_step, s.primal_step_old, s.theta, s.beta, layout.p,
            layout.m, opts.delta, opts.linsearch_decay,
            opts.max_linsearch_steps)
    tp = current_tp(opts)
    if not tp.sharded:
        y, Mty, theta, ps, _ = kernels.linesearch_loop(*args)
    else:
        y, Mty, theta, ps, _ = kernels.linesearch_loop_plain(
            *args, decide=tp.flag)
    return s.replace(
        y=y,
        Mty=Mty,
        theta=theta,
        primal_step=ps,
        primal_step_old=ps,
        dual_step=s.beta * ps,
    )


def _dual_step(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """Fixed-step dual update (pdhg.jl:584-609): K2 with theta = 1."""
    one = torch.ones((), dtype=s.y.dtype, device=s.y.device)
    y_temp, _ = kernels.ls_dual_update(
        s.y, s.Mx, s.Mx_old, o.b, o.h, s.y_old, s.dual_step, one,
        layout.p, layout.m,
    )
    return s.replace(y=y_temp, Mty=o.M.rmatvec(y_temp),
                     primal_step_old=s.primal_step)


def _residuals_and_gap(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """compute_residual! + compute_gap! (residuals.jl:2-71): K3's nine f64
    reductions, the scalar formulas of solver.py:563-612 in f64, and the
    ring writes in the program's dtype (an f32 program casts there, as
    the JAX f32 program does)."""
    p, m = layout.p, layout.m
    L = s.buf_gap.shape[-1]
    idx = torch.remainder(s.iter, L)  # (k - 1) % L with k = iter + 1
    args = (s.x, s.x_old, s.Mty, s.Mty_old, s.primal_step, s.y, s.y_old,
            s.Mx, s.Mx_old, s.dual_step, o.b, o.h, o.c, p, m)
    if s.x.dim() == 2:  # a batch of packed-triangle instances
        r = kernels.residuals_batch(*args).unbind(-1)
    else:
        # the sqrt(2) off-diagonal weight of the square-form blocks
        # (solver.py:539-557); feasibility in user units (582-597)
        r = kernels.residuals(*args, layout.sdp_sides if layout.square_form
                              else (), row_scale=o.row_unscale)
    norm_b, norm_h, norm_c = o.norm_b.double(), o.norm_h.double(), o.norm_c.double()
    # primal PPA residual (sqrt of the tri-equivalent coordinate count,
    # residuals.jl:46-55)
    pres = (
        math.sqrt(float(layout.n_tri)) * r[0]
        / torch.clamp_min(torch.maximum(r[1], torch.maximum(norm_b, norm_h)), 1.0)
    )
    dres = (
        math.sqrt(float(p + m)) * r[2]
        / torch.clamp_min(torch.maximum(r[3], norm_c), 1.0)
    )
    comb = torch.maximum(pres, dres)
    zero = torch.zeros(s.iter.shape, dtype=torch.float64, device=s.x.device)
    equa = r[4] / (1.0 + norm_b) if p else s.equa_feas.double()
    ineq = r[5] / (1.0 + norm_h) if m else s.ineq_feas.double()
    feas = torch.maximum(equa if p else zero, ineq if m else zero)
    dual_obj = zero
    if p:
        dual_obj = dual_obj - r[7]
    if m:
        dual_obj = dual_obj - r[8]
    obj_scale = o.obj_scale.double()
    prim_obj = r[6] * obj_scale
    dual_obj = dual_obj * obj_scale
    gap = torch.abs(prim_obj - dual_obj) / (
        1.0 + torch.abs(prim_obj) + torch.abs(dual_obj)
    )
    v = torch.stack([pres, dres, comb, feas, gap, prim_obj, dual_obj, equa,
                     ineq], dim=-1).to(s.x.dtype).unbind(-1)
    return s.replace(
        x_old=s.x,
        y_old=s.y,
        Mty_old=s.Mty,
        Mx_old=s.Mx,
        buf_pres=_set(s.buf_pres, idx, v[0]),
        buf_dres=_set(s.buf_dres, idx, v[1]),
        buf_comb=_set(s.buf_comb, idx, v[2]),
        buf_feas=_set(s.buf_feas, idx, v[3]),
        buf_gap=_set(s.buf_gap, idx, v[4]),
        buf_prim_obj=_set(s.buf_prim_obj, idx, v[5]),
        buf_dual_obj=_set(s.buf_dual_obj, idx, v[6]),
        equa_feas=v[7] if p else s.equa_feas,
        ineq_feas=v[8] if m else s.ineq_feas,
    )


def _bump_ranks(target, current, min_eig, sides_arr, opts: Options):
    """Adaptive target-rank increment (pdhg.jl:270-280, 289-303)."""
    eligible = ((current + opts.rank_slack) >= target) & (min_eig > opts.tol_psd)
    if opts.rank_increment == 0:
        new = target * opts.rank_increment_factor
    else:
        new = target + opts.rank_increment_factor
    return torch.where(eligible, torch.minimum(new, sides_arr), target)


def _control(s: State, o: Operands, layout: ConeLayout, opts: Options,
             sides_arr: torch.Tensor):
    """Convergence / rank-update / divergence / adaptive-step branching,
    in-loop infeasibility detection (pdhg.jl:246-332, 390-483) and
    adaptive restart-to-average (solver.py:653-911).  Branch-free on 0-d
    tensors: no host sync."""
    k = s.iter + 1
    L = s.buf_gap.shape[-1]
    idx = torch.remainder(k - 1, L)
    w = opts.convergence_window

    gap_k = _at(s.buf_gap, idx)
    feas_k = _at(s.buf_feas, idx)
    pres_k = _at(s.buf_pres, idx)
    dres_k = _at(s.buf_dres, idx)
    comb_k = _at(s.buf_comb, idx)
    prim_k = _at(s.buf_prim_obj, idx)
    dual_k = _at(s.buf_dual_obj, idx)
    # floor modulo, as jnp's %: k - w - 1 is negative early on
    comb_back = _at(s.buf_comb, torch.remainder(k - w - 1, L))

    def i32(b):
        return b.to(torch.int32)

    active = ~((s.cert_kind != 0) & (k < s.cert_wait_until))
    rank_update = s.rank_update + i32(active)

    if layout.sdp_sides:
        blk_conv = (
            (sides_arr < opts.min_size_krylov_eigs)
            | (s.target_rank > opts.max_target_rank_krylov_eigs)
            | (s.min_eig < opts.tol_psd)
        )
        rank_conv = torch.all(blk_conv, dim=-1)
    else:
        rank_conv = torch.ones_like(active)
    if layout.soc_lens:  # the SOC gap of the projection (solver.py:689-691)
        rank_conv = rank_conv & (s.max_soc_gap < opts.tol_soc)

    conv = (gap_k <= opts.tol_gap) & (feas_k <= opts.tol_feasibility)
    opt_ok = conv & rank_conv & (k > opts.min_iter)
    status = torch.where(
        active & opt_ok & (s.status == 0) & (k >= s.opt_block_until),
        1, s.status,
    )

    b1 = active & conv & ~opt_ok & (rank_update > w)
    b2 = active & ~conv & (k > w) & (comb_back < comb_k) & (rank_update > w)
    update_cont = s.update_cont + i32(b1 | b2)
    do_bump1 = b1
    do_bump2 = b2 & (update_cont > opts.divergence_min_update)
    new_target = _bump_ranks(s.target_rank, s.current_rank, s.min_eig,
                             sides_arr, opts)
    target_rank = torch.where(_col(do_bump1 | do_bump2), new_target,
                              s.target_rank)
    any_not_full = (torch.any(s.target_rank < sides_arr, dim=-1)
                    if layout.sdp_sides else torch.zeros_like(active))
    reset = do_bump1 | (do_bump2 & any_not_full)
    rank_update = torch.where(reset, 0, rank_update)
    update_cont = torch.where(reset, 0, update_cont)

    if opts.step_balance == "ratio":
        r_ = opts.step_balance_ratio
        b3 = active & ~conv & ~b2 & (pres_k > r_ * dres_k) & (k > w)
        b4 = active & ~conv & ~b2 & ~b3 & (dres_k > r_ * pres_k) & (k > w)
    else:
        b3 = (active & ~conv & ~b2 & (pres_k > opts.tol_primal)
              & (dres_k < opts.tol_dual) & (k > w))
        b4 = (active & ~conv & ~b2 & ~b3 & (pres_k < opts.tol_primal)
              & (dres_k > opts.tol_dual) & (k > w))
    ada_count = s.ada_count + i32(b3 | b4)
    fire3 = b3 & (ada_count > opts.adapt_window)
    fire4 = b4 & (ada_count > opts.adapt_window)
    ada_count = torch.where(fire3 | fire4, 0, ada_count)
    al = s.adapt_level
    if opts.line_search_flag:
        beta = torch.where(fire3, s.beta * (1.0 - al), s.beta)
        beta = torch.where(fire4, beta / (1.0 - al), beta)
        primal_step = torch.where(fire3, s.primal_step / torch.sqrt(1.0 - al),
                                  s.primal_step)
        primal_step = torch.where(fire4, primal_step * torch.sqrt(1.0 - al),
                                  primal_step)
        dual_step = s.dual_step
    else:
        beta = s.beta
        primal_step = torch.where(fire3, s.primal_step / (1.0 - al), s.primal_step)
        primal_step = torch.where(fire4, primal_step * (1.0 - al), primal_step)
        dual_step = torch.where(fire3, s.dual_step * (1.0 - al), s.dual_step)
        dual_step = torch.where(fire4, dual_step / (1.0 - al), dual_step)
    adapt_level = torch.where(fire3 | fire4, al * opts.adapt_decay, al)

    # in-loop infeasibility / unboundedness detection (not in cert mode)
    det = active & (s.cert_kind == 0) & (status == 0)
    after_min = k > opts.min_iter_max_obj
    c_inf1 = (after_min & (dual_k > opts.max_obj)) | torch.isnan(dual_k)
    c_unb1 = (after_min & (prim_k < -opts.max_obj)) | torch.isnan(prim_k)
    stalled_feas = (
        after_min
        & (gap_k > opts.infeas_limit_gap_tol)
        & (feas_k > opts.infeas_feasibility_tol)
        & (_max_abs_cyclic_diff(s.buf_feas) < opts.infeas_stable_feasibility_tol)
    )
    stall100 = (
        after_min
        & (gap_k > 1.0 - opts.infeas_gap_tol)
        & (_max_abs_cyclic_diff(s.buf_gap) < opts.infeas_stable_gap_tol)
    )
    c_inf3 = stall100 & (torch.abs(dual_k) > torch.abs(prim_k)) & (
        feas_k > opts.infeas_feasibility_tol
    )
    c_unb2 = stall100 & (torch.abs(prim_k) > torch.abs(dual_k)) & (
        feas_k <= opts.tol_feasibility
    )
    det_stall = det & (k >= s.infeas_block_until)
    status = torch.where(det & c_inf1, 6, status)
    status = torch.where(det & (status == 0) & c_unb1, 5, status)
    status = torch.where(det_stall & (status == 0) & stalled_feas, 6, status)
    status = torch.where(det_stall & (status == 0) & c_inf3, 6, status)
    status = torch.where(det_stall & (status == 0) & c_unb2, 5, status)
    ray5 = (
        (s.cert_kind == 5)
        & (status == 0)
        & (prim_k < -opts.certificate_obj_tol)
        & (feas_k < opts.tol_feasibility * torch.clamp_min(torch.abs(prim_k), 1.0))
    )
    status = torch.where(ray5, 7, status)

    restart_updates = {}
    if opts.restart == "adaptive":
        p, m = layout.p, layout.m
        ps = s.primal_step
        avg_x = s.avg_x + _col(ps) * s.x
        avg_y = s.avg_y + _col(ps) * s.y
        avg_Mx = s.avg_Mx + _col(ps) * s.Mx
        avg_Mty = s.avg_Mty + _col(ps) * s.Mty
        avg_w = s.avg_w + ps
        epoch = (
            active
            & (status == 0)
            & (s.cert_kind == 0)
            & ((k - s.last_restart_iter) >= opts.restart_window)
        )
        metric_k = (torch.maximum(gap_k, feas_k)
                    if opts.restart_trigger == "kkt" else gap_k)
        stalled = (
            epoch
            & (metric_k > min(opts.tol_gap, opts.tol_feasibility))
            & (metric_k > opts.restart_decay * s.last_restart_gap)
            & torch.isfinite(metric_k)
        )
        wsum = torch.clamp_min(avg_w, 1e-30)
        xa_ = avg_x / _col(wsum)
        ya_ = avg_y / _col(wsum)
        Mxa_ = avg_Mx / _col(wsum)
        po_a = _dot(o.c, xa_) * o.obj_scale
        do_a = torch.zeros_like(po_a)
        if p:
            do_a = do_a - _dot(o.b, ya_[..., :p])
        if m:
            do_a = do_a - _dot(o.h, ya_[..., p:])
        do_a = do_a * o.obj_scale
        gap_a = torch.abs(po_a - do_a) / (1.0 + torch.abs(po_a) + torch.abs(do_a))
        feas_a = torch.zeros_like(gap_a)
        if p:
            feas_a = torch.maximum(
                feas_a,
                torch.amax(torch.abs(Mxa_[..., :p] - o.b), -1) / (1.0 + o.norm_b)
            )
        if m:
            feas_a = torch.maximum(
                feas_a, torch.amax(Mxa_[..., p:] - o.h, -1) / (1.0 + o.norm_h)
            )
        metric_now = torch.maximum(gap_k, feas_k)
        metric_avg = torch.maximum(gap_a, feas_a)
        stalled = stalled & (metric_avg < 0.9 * metric_now)

        def mix(avg, cur):
            return torch.where(_col(stalled), avg, cur)

        xa = mix(xa_, s.x)
        ya = mix(ya_, s.y)
        Mxa = mix(Mxa_, s.Mx)
        Mtya = mix(avg_Mty / _col(wsum), s.Mty)
        keep = (~stalled).to(avg_w.dtype)
        restart_updates = dict(
            x=xa, x_old=xa, y=ya, y_old=ya,
            Mx=Mxa, Mx_old=Mxa, Mty=Mtya, Mty_old=Mtya,
            avg_x=avg_x * _col(keep), avg_y=avg_y * _col(keep),
            avg_Mx=avg_Mx * _col(keep), avg_Mty=avg_Mty * _col(keep),
            avg_w=avg_w * keep,
            last_restart_iter=torch.where(epoch, k, s.last_restart_iter),
            last_restart_gap=torch.where(epoch, metric_k, s.last_restart_gap),
        )

    return s.replace(
        status=status,
        rank_update=rank_update,
        update_cont=update_cont,
        ada_count=ada_count,
        target_rank=target_rank,
        beta=beta,
        primal_step=primal_step,
        dual_step=dual_step,
        adapt_level=adapt_level,
        iter=k,
        **restart_updates,
    )


def make_chunk_runner(layout: ConeLayout, opts: Options, *, device):
    """(run_chunk, iteration, fetch) for one problem geometry on ``device``
    (solver.py:914-963).

    ``run_chunk(s, o, chunk_end)`` iterates until the status flips or the
    iteration count reaches ``chunk_end``; it reads the status once per
    iteration (with the target ranks of the Lanczos blocks, where there
    are any; under tensor parallelism rank 0's).  ``fetch(s)`` returns the
    14 host-monitored scalars as one NumPy array (one device-to-host
    copy)."""
    sides_arr = torch.tensor(layout.sdp_sides or (1,), dtype=torch.int32,
                             device=device)
    singles = block_plan(layout, opts).singles
    nb = max(len(layout.sdp_sides), 1)
    tp = current_tp(opts)

    def lanczos_blocks(s: State) -> list:
        # the Lanczos branch's target rank is a host decision, read with
        # the iteration count or the status in one transfer
        return [bi for bi, _, side in singles
                if projection_kind(side, opts, s.warm[bi].dim() == 2)
                == "lanczos"]

    def host_ranks(lz, vals) -> tuple:
        ranks = [None] * nb
        for bi, v in zip(lz, vals):
            ranks[bi] = int(v)
        return tuple(ranks)

    def counters(s: State):
        """(s.iter, the target ranks of the Lanczos blocks or None) on the
        host."""
        lz = lanczos_blocks(s)
        if lz:
            v = tp.values(torch.cat([s.iter.reshape(1),
                                     s.target_rank[lz]]).tolist())
            return int(v[0]), host_ranks(lz, v[1:])
        return int(tp.values([int(s.iter)])[0]), None

    def iteration(s: State, o: Operands, k: int | None = None,
                  target_ranks: tuple | None = None) -> State:
        # k: the iteration count s.iter and target_ranks: each block's
        # s.target_rank (Lanczos blocks only) when the caller knows them,
        # else read here
        if k is None or (target_ranks is None and lanczos_blocks(s)):
            k, target_ranks = counters(s)
        s = _primal_step(s, o, layout, opts, k, target_ranks)
        if opts.line_search_flag:
            s = _linesearch(s, o, layout, opts)
        else:
            s = _dual_step(s, o, layout, opts)
        s = _residuals_and_gap(s, o, layout, opts)
        return _control(s, o, layout, opts, sides_arr)

    def run_chunk(s: State, o: Operands, chunk_end: int) -> State:
        lz = lanczos_blocks(s)
        k, tr = counters(s)
        while k < chunk_end:
            s = iteration(s, o, k, tr)
            k += 1
            if lz:
                v = tp.values(torch.cat([s.status.reshape(1),
                                         s.target_rank[lz]]).tolist())
                st, tr = int(v[0]), host_ranks(lz, v[1:])
            else:
                st = int(tp.values([int(s.status)])[0])
            if st != 0:
                break
        return s

    def fetch(s: State) -> np.ndarray:
        L = s.buf_gap.shape[0]
        i = torch.remainder(s.iter - 1, L)
        ft = s.buf_gap.dtype
        vals = torch.stack([
            s.iter.to(ft),
            s.status.to(ft),
            _at(s.buf_gap, i),
            _at(s.buf_feas, i),
            _at(s.buf_prim_obj, i),
            _at(s.buf_dual_obj, i),
            _at(s.buf_pres, i),
            _at(s.buf_dres, i),
            _at(s.buf_comb, i),
            torch.sum(s.target_rank).to(ft),
            s.proj_fallbacks.to(ft),
            s.sub_stats[0],
            s.sub_stats[1],
            s.sub_stats[2],
        ])
        return vals.cpu().numpy()

    return run_chunk, iteration, fetch


def _row_norm_spread(setup) -> float:
    """max/min nonzero row 2-norm of M = [A; G] (solver.py:2546)."""
    M = sp.csr_matrix(stack_vertical(setup.A, setup.G))
    if M.shape[0] == 0:
        return 1.0
    rn = np.sqrt(np.asarray(M.multiply(M).sum(axis=1)).ravel())
    rn = rn[rn > 0]
    if rn.size == 0:
        return 1.0
    return float(rn.max() / rn.min())


def _probe_score(res: Result, problem) -> float:
    """Progress of a probe arm (solver.py:2360-2375): max(rel gap, rel
    linear violation), lower is better; inf for a missing or non-finite
    result."""
    if res is None or res.primal.size == 0:
        return float("inf")
    x = res.primal
    lin = 0.0
    if problem.A is not None and getattr(problem.A, "shape", (0,))[0]:
        r = np.abs(np.asarray(problem.A @ x).ravel() - problem.b)
        lin = max(lin, float(r.max())
                  / (1.0 + float(np.abs(problem.b).max(initial=0.0))))
    if problem.G is not None and getattr(problem.G, "shape", (0,))[0]:
        r = np.maximum(np.asarray(problem.G @ x).ravel() - problem.h, 0.0)
        lin = max(lin, float(r.max())
                  / (1.0 + float(np.abs(problem.h).max(initial=0.0))))
    gap = abs(res.gap) if np.isfinite(res.gap) else float("inf")
    score = max(gap, lin)
    return score if np.isfinite(score) else float("inf")


def _solve_with_beq_probe(problem, opts: Options, t0: float,
                          device) -> Result:
    """block_equilibration="auto" (solver.py:2378-2501): race the default
    and the block-equilibrated pipelines for a short probe, then finish
    with the winner, warm-started from its probe iterate.

    Each round runs both arms ``block_equilibration_probe_iters`` deep
    (doubling while their scores lie within the margin, up to four
    rounds), each capped at probe_t = max(min(0.05 time_limit, 20), 2)
    seconds; the probe stops early once an arm solves or it has taken a
    quarter of the time limit.  An arm that solved wins; when both arms
    still score above 0.3 the equilibrated one does; else the margin
    decides.  The final solve gets the time that is left.  An arm that
    raises is dropped, as in the JAX package, unless the error is a
    ``kernels.KernelError`` (a kernel that does not build or launch),
    which propagates, as does a divergence of tensor-parallel ranks.  The
    clock is ``_clock(opts)`` and the stop and winner decisions are
    ``current_tp(opts)``'s (rank 0's under tensor parallelism)."""
    tp, now = current_tp(opts), _clock(opts)
    margin = max(opts.block_equilibration_probe_margin, 1.0)
    probe_t = max(min(0.05 * opts.time_limit, 20.0), 2.0)
    base = dict(certificate_search=False, log_verbose=False,
                timer_verbose=False, warn_on_limit=False, checkpoint_path="")
    arms: dict = {False: None, True: None}
    scores = {False: float("inf"), True: float("inf")}
    depth = int(opts.block_equilibration_probe_iters)
    for _round in range(4):
        round_t = max(min(probe_t, opts.time_limit - (now() - t0)), 1.0)
        for variant in (False, True):
            prev = arms[variant]
            warm = prev if prev is not None and prev.status in (2, 3) else None
            try:
                arms[variant] = solve(
                    problem,
                    opts.replace(block_equilibration=variant, max_iter=depth,
                                 time_limit=round_t, **base),
                    warm_start=warm, device=device)
            except (kernels.KernelError, RankDivergence):
                raise  # a kernel that does not build or launch is a fault
            except Exception as e:  # a probe must never kill the solve
                if opts.log_verbose:
                    print(f"  [beq probe] arm {variant} failed: {e}")
                arms[variant] = None
        scores = {v: _probe_score(r, problem) for v, r in arms.items()}
        if opts.log_verbose:
            its = [str(arms[v].iter) if arms[v] is not None else "-"
                   for v in (False, True)]
            print(f"  [beq probe] depth {depth}: default {scores[False]:.3e} "
                  f"vs block-equilibrated {scores[True]:.3e} (iterations "
                  f"{' / '.join(its)})")
        solved = any(r is not None and r.status == 1 for r in arms.values())
        separated = (scores[True] * margin < scores[False]
                     or scores[False] * margin < scores[True])
        stop = solved or separated or now() - t0 > 0.25 * opts.time_limit
        if tp.flag(stop):
            break
        depth *= 2
    # an arm that solved wins; two arms still far from converging make
    # the probe uninformative, and the spread that triggered it points to
    # the equilibrated arm (unless that one crashed or diverged)
    opt1 = {v: arms[v] is not None and arms[v].status == 1 for v in arms}
    if opt1[True] != opt1[False]:
        winner = opt1[True]
    elif (min(scores.values()) > 0.3 and arms[True] is not None
          and np.isfinite(scores[True])):
        winner = True
    else:
        winner = bool(scores[True] * margin < scores[False])
    winner = tp.flag(winner)
    wres = arms[winner]
    if opts.log_verbose:
        print(f"  [beq probe] -> "
              f"{'block-equilibrated' if winner else 'default'}")
    if opts.log_verbose or opts.timer_verbose:
        print(f"  [beq probe] probe consumed {now() - t0:.1f}s before "
              "the main solve")
    if wres is not None and wres.status == 1:
        wres.time = now() - t0
        return wres
    warm = None
    if (wres is not None and wres.status in (2, 3)
            and np.isfinite(scores[winner])):
        warm = wres
    remaining = opts.time_limit - (now() - t0)
    return solve(problem, opts.replace(block_equilibration=winner,
                                       time_limit=max(remaining, 1.0)),
                 warm_start=warm, device=device)


# ---------------------------------------------------------------------------
# Host-side subspace sizing and the precision hand-over (solver.py:1031-1125)
# ---------------------------------------------------------------------------


def _sub_bucket(k: int) -> int:
    """Round a subspace width up to a bounded set of buckets; 0 = rank too
    large, use the dense eigh (solver.py:1031-1044)."""
    for b in (16, 24, 32, 48, 64, 96, 128, 192, 256):
        if k <= b:
            return b
    return 0


def _estimate_subspace(state: State, layout: ConeLayout, opts: Options, c_host):
    """Host eigh of the PRE-projection matrix x - tau*(M'y + c): its
    relative-threshold rank and exact basis (solver.py:1047-1096).

    Returns (k_bucket, r_obs, specs) with specs = [(side, V, r_blk)];
    k_bucket == 0 means the observed rank is too large for subspace mode.
    Under tensor parallelism (k_bucket, r_obs) are rank 0's; each rank
    seeds from its own replicated basis."""
    x_host = state.x.cpu().numpy().astype(np.float64) - float(state.primal_step) * (
        state.Mty.cpu().numpy().astype(np.float64) + np.asarray(c_host, np.float64)
    )
    specs = []
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        if layout.square_form:
            Xm = x_host[off : off + side * side].reshape(side, side)
            Xm = 0.5 * (Xm + Xm.T)
        else:  # the packed triangle, unpacked (solver.py:1079-1086)
            gidx, in_scale, _, _ = kernels._maps(side)
            Xm = (x_host[off : off + sympackedlen(side)][gidx]
                  * in_scale).reshape(side, side)
        w, V = np.linalg.eigh(Xm)
        lam_max = max(float(w[-1]), 0.0)
        r_blk = int(np.sum(w > max(opts.tol_psd, 1e-4 * max(lam_max, 1e-12))))
        specs.append((side, V, r_blk))
    if not specs:
        return 0, 0, specs
    r_obs = max(r for _, _, r in specs)
    k = _sub_bucket(r_obs + opts.polish_subspace_guard)
    if not (k and any(k < side // 2 for side in layout.sdp_sides)):
        k = 0
    k, r_obs = (int(v) for v in current_tp(opts).values([k, r_obs]))
    return k, r_obs, specs


def _seed_subspace_warm(state: State, specs, k: int, dtype) -> State:
    """Warm bases := the exact top-k eigenvectors from _estimate_subspace
    for the blocks that run in subspace mode (solver.py:1099-1110)."""
    warm = []
    for bi, (side, V, _r) in enumerate(specs):
        k_sub = int(min(k, side))
        if 0 < k_sub < side // 2:
            Vk = V[:, -k_sub:][:, ::-1].copy()
            warm.append(torch.tensor(Vk, dtype=dtype, device=state.x.device))
        else:
            warm.append(state.warm[bi].to(dtype))
    return state.replace(warm=tuple(warm))


def _collapse_warm(state: State) -> State:
    """A (side, k) basis becomes its dominant column (the vector warm start
    of a program without the subspace step)."""
    return state.replace(warm=tuple(w[:, 0].contiguous() if w.dim() == 2 else w
                                    for w in state.warm))


def _cast_state(s: State, dtype) -> State:
    """Float fields to ``dtype`` (the hybrid hand-over) with the status
    cleared, so the target program re-judges convergence
    (solver.py:1113-1125)."""
    kw = {}
    for name in STATE_FIELDS:
        v = getattr(s, name)
        if name == "warm":
            kw[name] = tuple(w.to(dtype) for w in v)
        else:
            kw[name] = v.to(dtype) if v.is_floating_point() else v
    kw["status"] = torch.zeros_like(s.status)
    return State(**kw)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


class _Budget:
    """Iteration/time budgets (reference opt.max_iter_local)."""

    def __init__(self, opts: Options, has_cones: bool):
        if opts.max_iter <= 0:
            self.max_iter = opts.max_iter_conic if has_cones else opts.max_iter_lp
        else:
            self.max_iter = opts.max_iter
        self.hard_cap = 2 * self.max_iter
        self.time_limit = opts.time_limit


# The port's chunk: a fixed number of iterations between host checks.  The
# JAX driver sizes chunks from measured rates (solver.py:1454-1514,
# 1650-1670), so its hybrid switch points move with the clock; this one
# does not (ROADMAP C9).
DEFAULT_CHUNK = 256

_SNAP_FIELDS = (
    "x", "y", "iter", "current_rank", "buf_gap", "buf_prim_obj",
    "buf_dual_obj", "buf_feas", "buf_pres", "buf_dres",
)

_SCALARS = ("iter", "status", "gap", "feas", "prim_obj", "dual_obj", "pres",
            "dres", "comb", "sum_target_rank", "proj_fallbacks",
            "sub_rel_resid", "sub_min_theta", "sub_npos")
_INT_SCALARS = {"iter", "status", "sum_target_rank", "proj_fallbacks",
                "sub_npos"}


@contextlib.contextmanager
def _ieee_f32_products():
    """IEEE f32 in torch's own matrix products while the solve runs.  The
    subspace step's tall-skinny products and reconstructions are
    ``torch.matmul`` calls: a caller's ``set_float32_matmul_precision``
    ("high" or "medium") would give them TF32 on the card or bf16 on the
    CPU.  The caller's setting is put back afterwards."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    prev = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, p in zip(backends, prev):
            b.fp32_precision = p


def solve(problem, options: Options | None = None, *, warm_start=None,
          resume_from: str | None = None, device="cuda", **kwargs) -> Result:
    """Solve a ConicProblem (or a preprocessed SetupProblem) on ``device``.

    The host driver of solver.py:1209-2357.  ``warm_start``: a previous
    Result for the same problem geometry, or a tuple (x, dual_eq, dual_in)
    in user variable order.  ``resume_from``: a checkpoint written under
    ``checkpoint_path`` / ``checkpoint_freq`` (by this package or the JAX
    one: one format) -- the loop continues from the saved state, in the
    saved program (same problem and layout required).  With
    ``block_equilibration="auto"`` (the
    default) a problem whose constraint-row norms spread more than
    ``block_equilibration_probe_spread`` races both preconditioners for a
    short probe and continues with the winner (``_solve_with_beq_probe``).
    Under the default
    ``Options()`` (f64 with ``hybrid_precision``) an f32 race runs first --
    the polar projection, then from ``race_subspace_warmup`` on the f32
    subspace step with a polar reseed -- and hands over to an f64 polish on
    the mixed-precision subspace step, which alone may declare OPTIMAL;
    ``hybrid_precision=False`` runs one program.  Also: the iteration and
    time limits, best-iterate tracking, the polish watchdog (guarded step
    restart, subspace re-estimate), limit statuses, the certificate
    search after an INFEASIBLE (6) or UNBOUNDED (5) declaration (a status
    5 or 6 comes back only with a ray, ``certificate_found``; an unproven
    one is demoted to the limit status with "Suspected" in its string),
    logging, the timer report and solution recovery.  ``device`` defaults
    to the CUDA card;
    without one it raises (pass ``device="cpu"`` for the plain PyTorch
    path).  Library products run in IEEE f32 whatever the caller's
    float32 matmul precision.
    """
    with _ieee_f32_products():
        return _solve(problem, options, device, kwargs, warm_start,
                      resume_from)


def _solve(problem, options: Options | None, device, kwargs,
           warm_start=None, resume_from=None) -> Result:
    opts = options or Options()
    if kwargs:
        opts = opts.replace(**kwargs)
    # a tensor-parallel solve: rank 0's clock, and only rank 0 prints
    tp, now = current_tp(opts), _clock(opts)
    if tp.rank != 0:
        opts = opts.replace(log_verbose=False, timer_verbose=False,
                            timer_file=False)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "solve: no CUDA card is available (torch.cuda.is_available() is "
            "false); pass device='cpu' for the plain PyTorch path")

    t0 = now()
    setup = (
        preprocess(problem, scale_objective=opts.scale_objective,
                   scale_rhs=opts.scale_rhs)
        if isinstance(problem, ConicProblem)
        else problem
    )
    if opts.log_verbose:
        _print_header(setup.layout, opts, device)
    # block_equilibration="auto": race both preconditioners for a short
    # probe and continue with the winner (solver.py:1246-1257)
    if (opts.block_equilibration == "auto"
            and opts.block_equilibration_probe_spread > 0
            and warm_start is None and resume_from is None
            and isinstance(problem, ConicProblem)
            and _row_norm_spread(setup) > opts.block_equilibration_probe_spread):
        return _solve_with_beq_probe(problem, opts, t0, device)

    # diagonal preconditioning (solver.py:1259-1274): mutates setup.A/G/b/
    # h/c before the operator and the step sizes are built
    equil = None
    beq = opts.block_equilibration
    if isinstance(beq, str) and beq != "auto":
        # an option string ("True", "off", "0"): only a recognised yes
        # turns the preconditioner on
        beq = beq.lower() in ("1", "true", "yes", "on")
    if beq == "auto":
        beq = _row_norm_spread(setup) > opts.block_equilibration_spread
    if beq:
        equil = block_equilibrate_host(setup, opts)
    elif opts.equilibration or opts.equilibration_force:
        equil = equilibrate_host(setup, opts)

    # the square-form device coordinates (solver.py:1276-1285): setup_h
    # keeps the packed-triangle data for solution recovery and the checks
    setup_h = setup
    if opts.square_form and setup.layout.sdp_sides:
        setup = to_square_form(setup)
    layout = setup.layout

    def make_operands(dt):
        M = build_linop(setup.A, setup.G, dt, device=device,
                        force=None if opts.linop == "auto" else opts.linop)
        if tp.sharded:
            M = shard_linop(M, tp)
        return convert.operands_from_numpy(
            M=M, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
            norm_h=setup.norm_h, norm_c=setup.norm_c,
            obj_scale=setup.obj_scale * setup.rhs_scale, device=device,
            dtype=dt, row_unscale=None if equil is None else 1.0 / equil.E,
        )

    warm = None
    if warm_start is not None:
        warm = _warm_to_solver(warm_start, setup_h, layout, equil)

    def runner(po: Options):
        run, _, fetch_ = make_chunk_runner(layout, po, device=device)
        return run, fetch_

    # under TP: (iteration, checksums of x, y and the warm starts, and the
    # rank's own fetched scalars) at every chunk end, held equal across the
    # ranks at the end of the solve.  The split work is gathered into every
    # rank's x and y; what a rank computes alone (the replicated eigh's
    # ranks, a subspace step, the residuals on its own operands) shows in
    # the others.
    checks = []

    dtype = torch.float64 if opts.dtype == "float64" else torch.float32
    operands = make_operands(dtype)
    run_chunk, fetch = runner(opts)
    # race and polish on the f32 and f64 programs: only the f64 program
    # ever declares OPTIMAL
    hybrid = opts.dtype == "float64" and opts.hybrid_precision
    if hybrid:
        opts32 = opts.replace(dtype="float32")
        if opts.projection == "auto":
            # race: the matmul-only polar projection, and polar reseeds as
            # the subspace step's fallback
            opts32 = opts32.replace(projection="polar",
                                    subspace_fallback="polar")
        operands32 = make_operands(torch.float32)
        run_chunk32, fetch32 = runner(opts32)
        state = convert.state_from_numpy(
            init_state(layout, opts32, setup, warm=warm), device)
        phase32 = True
    else:
        state = convert.state_from_numpy(
            init_state(layout, opts, setup, warm=warm), device)
        phase32 = False

    # race subspace entry: retried while the observed rank is too large
    sub32 = {"entered": False, "tries": 0, "retry_at": opts.race_subspace_warmup}
    # polish watchdog: on a gap stall restart the steps and re-estimate the
    # subspace rank (escalate the bucket or drop to the dense program);
    # "guard" holds the pre-restart state for the rollback
    polish = {"k_sub": 0, "best": float("inf"), "since": None,
              "window_mult": 1, "guard": None}
    # above polar_fallback_min_side the f64 subspace programs reseed with
    # the f32-compute polar projection instead of a dense f64 eigh
    big_side = bool(layout.sdp_sides) and max(layout.sdp_sides) > min(
        opts.full_eig_max_side, opts.polar_fallback_min_side)
    polish_fb = {"subspace_fallback": "polar"} if big_side else {}

    if resume_from:
        # solver.py:1411-1445: the saved program's runner, rebuilt from the
        # saved basis width where the checkpoint was taken in a subspace
        # program (the f32 race's or the polish's)
        state, saved_phase32 = load_checkpoint(
            resume_from, expect_square_form=layout.square_form, device=device)
        sub_saved = (layout.sdp_sides and state.warm[0].dim() == 2
                     and opts.subspace_rank == 0)
        if hybrid and saved_phase32:
            phase32 = True
            if sub_saved:
                run_chunk32, fetch32 = runner(opts32.replace(
                    subspace_rank=int(state.warm[0].shape[1])))
                sub32["entered"] = True
        else:
            phase32 = False
            if state.x.dtype != dtype:
                state = _cast_state(state, dtype)
            if sub_saved:
                run_chunk, fetch = runner(opts.replace(
                    subspace_rank=int(state.warm[0].shape[1]), **polish_fb))

    budget = _Budget(opts, bool(layout.sdp_sides or layout.soc_lens))
    chunk = opts.chunk_iters or DEFAULT_CHUNK
    log_next = opts.log_freq
    ckpt_next = opts.checkpoint_freq
    stall_window = max(3 * opts.convergence_window, 1500)
    hybrid_best = {"value": float("inf"), "since": 0}
    # best iterate by max(gap, feas), snapshot at most every 2 s: "snap"
    # the fields _cache_solution reads, "full" every field (a failed
    # certificate search resumes from it while "tag", the program that
    # took it, is still the current one)
    best = {"score": float("inf"), "snap": None, "full": None, "tag": None,
            "t": t0}
    # the certificate search (solver.py:1516-1523): "mode" the status being
    # certified (0: none), "snapshot" the Result at the declaration,
    # "resume" the host state before the search, "entries" the searches
    # started (at most _MAX_CERT_SEARCHES)
    cert = _no_search(0)
    tau0 = float(state.primal_step)
    timers = {"setup": time.time() - t0, "f32 loop": 0.0, "f64 loop": 0.0,
              "host sync": 0.0, "snapshot": 0.0, "finalize": 0.0}
    chunk_counts = {"f32": 0, "f64": 0}
    # projection fallbacks of the race are polar reseeds, not dense eighs:
    # the counter at the hand-over splits the report
    fb_ctx = {"f32": 0,
              "f32_is_polar": hybrid and opts32.subspace_fallback == "polar"}
    final_status = None
    status_string = None

    def take_snapshot(score):
        t_snap = time.time()
        best["t"] = now()
        best["score"] = score
        host = convert.state_to_numpy(state)
        best["full"] = host
        best["tag"] = (phase32, polish["k_sub"])
        best["snap"] = {f: host[f] for f in _SNAP_FIELDS}
        timers["snapshot"] += time.time() - t_snap

    def enter_search(st, status_string):
        # the declaration's Result and state are kept, then the ray search
        # starts on the zeroed operands (solver.py:2195-2215, 2238-2254)
        nonlocal operands, state
        score_now = max(sc["gap"], sc["feas"])
        if np.isfinite(score_now) and score_now < best["score"]:
            take_snapshot(score_now)
        host = convert.state_to_numpy(state)
        cert["snapshot"] = _cache_solution(
            host, setup_h, opts, t0, status=st, status_string=status_string,
            exact_project=big_side, equil=equil,
            square_form=layout.square_form)
        cert["resume"] = host
        operands, state = _enter_certificate_mode(st, operands, state, budget,
                                                  opts)
        cert["mode"] = st
        cert["entries"] += 1
        _set_cert_deadlines(cert, state, opts, k)
        if opts.log_verbose:
            print(f"  [cert] status {st} at iter {k}: ray search {cert['entries']}"
                  f", checks from iter {int(state.cert_wait_until)}, deadlines "
                  f"iter {cert['deadline_k']} and "
                  f"{cert['deadline_t'] - time.time():.0f} s")

    while True:
        k0 = int(state.iter)
        cap = budget.hard_cap if cert["mode"] else budget.max_iter
        step_n = 1 if (now() - t0) >= budget.time_limit else chunk
        target = min(k0 + step_n, cap)
        if not (target <= k0 and k0 > 0):
            target = max(target, k0 + 1)
            t_chunk = time.time()
            if phase32:
                state = run_chunk32(state, operands32, target)
            else:
                state = run_chunk(state, operands, target)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timers["f32 loop" if phase32 else "f64 loop"] += time.time() - t_chunk
            chunk_counts["f32" if phase32 else "f64"] += 1
        t_sync = time.time()
        v = (fetch32 if phase32 else fetch)(state)
        if tp.sharded:
            # every rank decides on rank 0's scalars; its own go into the
            # checks with its checksums
            checks.append((int(v[0]), _checksums(state) + v.tolist()))
        v = np.asarray(tp.values(v.tolist()))
        sc = {name: int(x) if name in _INT_SCALARS else float(x)
              for name, x in zip(_SCALARS, v)}
        timers["host sync"] += time.time() - t_sync
        k, st = sc["iter"], sc["status"]
        elapsed = now() - t0

        if not cert["mode"] and k > 0:
            score = max(sc["gap"], sc["feas"])
            if (np.isfinite(score) and score < 0.95 * best["score"]
                    and now() - best["t"] >= 2.0):
                take_snapshot(score)

        if opts.log_verbose and k >= log_next:
            dfeas = None
            if opts.extended_log2:
                _, dfeas = _dual_cone(_user_duals(state, equil, setup_h),
                                      setup_h, setup_h.c_orig)
            _log_progress(sc, elapsed, opts, dfeas)
            log_next += opts.log_freq

        # a checkpoint at a chunk end outside the certificate search
        # (solver.py:1721-1735)
        if (opts.checkpoint_path and opts.checkpoint_freq > 0
                and not cert["mode"] and k >= ckpt_next):
            if tp.rank == 0:  # one writer
                save_checkpoint(opts.checkpoint_path, state, phase32,
                                square_form=layout.square_form)
            ckpt_next = k + opts.checkpoint_freq

        if phase32:
            # hand over on any f32 status, at a budget boundary, or when the
            # race stalls (near tolerance: a quarter-length window); the f64
            # program re-judges everything (solver.py:1736-1905)
            metric = max(sc["gap"], sc["feas"])
            if metric < hybrid_best["value"] / 1.2:
                hybrid_best.update(value=metric, since=k)
            near = (sc["gap"] <= opts.hybrid_switch_factor * opts.tol_gap
                    and sc["feas"] <= opts.hybrid_switch_factor
                    * opts.tol_feasibility)
            no_improve = k - hybrid_best["since"]
            switch = (
                st != 0
                or (near and no_improve >= max(stall_window // 4,
                                               2 * opts.convergence_check))
                or no_improve >= stall_window
                or k >= budget.max_iter
                or elapsed >= budget.time_limit
            )
            if switch:
                stalled = no_improve >= stall_window and st == 0
                blew_up = not (np.isfinite(sc["comb"])
                               and np.isfinite(sc["prim_obj"])
                               and np.isfinite(sc["dual_obj"]))
                if opts.log_verbose:
                    print(f"  [hybrid] f32 -> f64 at iter {k} "
                          f"(st={st}, stalled={stalled}, nan={blew_up})")
                fb_ctx["f32"] = sc["proj_fallbacks"]
                phase32 = False
                if blew_up:
                    # the race diverged: restart clean in f64
                    fresh = init_state(layout, opts, setup, warm=warm)
                    fresh["iter"] = np.int32(k)
                    state = convert.state_from_numpy(fresh, device)
                    continue
                state = _cast_state(state, torch.float64)
                entered_polish = False
                if (opts.polish_subspace and opts.subspace_rank == 0
                        and layout.sdp_sides):
                    k_sub, r_obs, specs = _estimate_subspace(
                        state, layout, opts, setup.c)
                    if k_sub:
                        run_chunk, fetch = runner(
                            opts.replace(subspace_rank=k_sub, **polish_fb))
                        state = _seed_subspace_warm(state, specs, k_sub,
                                                    torch.float64)
                        entered_polish = True
                        polish["k_sub"] = k_sub
                        if opts.log_verbose:
                            print(f"  [hybrid] f64 polish: subspace rank "
                                  f"{k_sub} (observed {r_obs})")
                if (not entered_polish and opts.subspace_rank == 0
                        and layout.sdp_sides and state.warm[0].dim() == 2):
                    state = _collapse_warm(state)
                if stalled:
                    # the race wedged its step machinery: restart the steps
                    # at the hand-over, keeping the iterates
                    state = state.replace(**_step_reset(
                        opts, device, tau0, tau0, beta=opts.initial_beta))
            elif (opts.race_subspace and not sub32["entered"]
                  and sub32["tries"] < 5 and opts.subspace_rank == 0
                  and layout.sdp_sides and k >= sub32["retry_at"]):
                # past the cold start: size an f32 subspace program from the
                # observed rank and seed it with the exact top-k basis
                sub32["tries"] += 1
                k_sub, r_obs, specs = _estimate_subspace(
                    state, layout, opts, setup.c)
                if not k_sub:
                    sub32["retry_at"] = k + max(opts.race_subspace_warmup,
                                                opts.convergence_check)
                else:
                    sub32["entered"] = True
                    run_chunk32, fetch32 = runner(
                        opts32.replace(subspace_rank=k_sub))
                    state = _seed_subspace_warm(state, specs, k_sub,
                                                torch.float32)
                    if opts.log_verbose:
                        print(f"  [hybrid] f32 race: subspace rank {k_sub} "
                              f"(observed {r_obs})")
            continue

        in_cert = cert["mode"] != 0

        # guarded-restart rollback: a step restart that blew the metric up
        # (or led to a 5/6 declaration) within one chunk is undone and
        # further restarts are suppressed (solver.py:1909-1944)
        g = polish["guard"]
        if g is not None and not in_cert and k > g[2]:
            g_state, g_metric, _, g_k_sub = g
            polish["guard"] = None
            metric_now = max(sc["gap"], sc["feas"])
            if g_k_sub == polish["k_sub"] and (
                    not np.isfinite(metric_now)
                    or metric_now > 5 * max(g_metric, 1e-12) or st in (5, 6)):
                g_state.update(iter=np.int32(k), status=np.int32(0),
                               infeas_block_until=np.int32(k + stall_window))
                state = convert.state_from_numpy(g_state, device)
                polish.update(window_mult=16, since=k, best=g_metric)
                if opts.log_verbose:
                    print(f"  [polish] restart hurt (metric {g_metric:.2e} -> "
                          f"{metric_now:.2e}): rolled back, restarts "
                          "suppressed")
                continue

        # polish watchdog (solver.py:1946-2052)
        if not in_cert and st == 0 and sc["gap"] > opts.tol_gap:
            metric = max(sc["gap"], sc["feas"])
            if polish["since"] is None:
                polish["since"] = k
            if metric < polish["best"] / 1.2:
                polish.update(best=metric, since=k, window_mult=1)
            if opts.polish_restart and (
                k - polish["since"] >= stall_window * polish["window_mult"]
            ):
                polish.update(since=k, best=metric,
                              window_mult=min(2 * polish["window_mult"], 16))
                polish["guard"] = (convert.state_to_numpy(state), metric, k,
                                   polish["k_sub"])
                # re-split the steps around sqrt(beta): the learned balance
                # stays, the stability product tau_p * tau_d does too
                sq = math.sqrt(float(state.beta))
                state = state.replace(**_step_reset(
                    opts, device, tau0 / sq, tau0 * sq))
                if opts.log_verbose:
                    print(f"  [polish] stall at gap {sc['gap']:.2e}: "
                          "step restart")
                k_cur = polish["k_sub"]
                if k_cur:
                    k_new, r_obs, specs = _estimate_subspace(
                        state, layout, opts, setup.c)
                    if k_new > k_cur:
                        run_chunk, fetch = runner(
                            opts.replace(subspace_rank=k_new, **polish_fb))
                        state = _seed_subspace_warm(state, specs, k_new,
                                                    torch.float64)
                        polish["k_sub"] = k_new
                        if opts.log_verbose:
                            print(f"  [polish] stall at gap {sc['gap']:.2e}: "
                                  f"subspace rank {k_cur} -> {k_new} "
                                  f"(pre-projection rank {r_obs})")
                    elif k_new == 0 and not big_side:
                        # rank too large for any bucket: the dense program
                        run_chunk, fetch = runner(opts)
                        state = _collapse_warm(state)
                        polish["k_sub"] = 0
                        if opts.log_verbose:
                            print(f"  [polish] stall at gap {sc['gap']:.2e}: "
                                  f"subspace rank {k_cur} -> dense eigh "
                                  f"(pre-projection rank {r_obs})")

        # certificate-search monitoring (solver.py:2054-2150): a ray ends
        # the search; a failed search (no ray by its deadline, or the
        # modified problem converged) resumes the solve from the state
        # before it while searches and budget remain, else demotes
        if in_cert and (k >= int(state.cert_wait_until) or st == 7):
            done, found = tp.obj(_check_certificate(sc, state, setup_h, opts,
                                                    cert["mode"], st))
            ended_by = "a ray" if found else "its fail test" if done else ""
            if not done and k >= cert["deadline_k"]:
                done, ended_by = True, f"the iteration deadline {cert['deadline_k']}"
            elif not done and now() >= cert["deadline_t"]:
                done, ended_by = True, "the clock deadline"
            if done or st == 1:
                if opts.log_verbose:
                    print(f"  [cert] search {cert['entries']} ended at iter {k}"
                          f" by {ended_by or 'a solution of the modified problem'}")
                if (not found and cert["resume"] is not None
                        and cert["entries"] < _MAX_CERT_SEARCHES
                        and k < budget.max_iter and elapsed < budget.time_limit):
                    # resume from the best iterate when its program is the
                    # current one, else from the declaration's state; the
                    # stall detection stays off for a window
                    rs = dict(best["full"] if best["full"] is not None
                              and best["tag"] == (phase32, polish["k_sub"])
                              else cert["resume"])
                    rs.update(iter=np.int32(k), status=np.int32(0),
                              cert_kind=np.int32(0),
                              infeas_block_until=np.int32(k + 2 * stall_window))
                    state = convert.state_from_numpy(rs, device)
                    polish.update(since=k, best=best["score"], window_mult=2)
                    operands = make_operands(dtype)
                    cert = _no_search(cert["entries"])
                    if opts.log_verbose:
                        print("  [cert] no ray found: resuming the solve "
                              "(detection suppressed until iter "
                              f"{k + 2 * stall_window})")
                    continue
                cert["found"] = found
                if found:
                    final_status = cert["mode"]
                    status_string = STATUS_STRINGS[final_status] + (
                        " [Dual ray found]" if final_status == 6
                        else " [Primal ray found]")
                else:
                    final_status, status_string = _unproven_status(
                        budget, k, cert["mode"])
                break

        if st == 1 and not in_cert:
            if opts.check_dual_feas:
                _, dfeas = _dual_cone(_user_duals(state, equil, setup_h),
                                      setup_h, setup_h.c_orig)
                if tp.obj(dfeas >= opts.tol_feasibility_dual):
                    # veto, and suppress re-declaration for a window
                    state = state.replace(
                        status=torch.zeros((), dtype=torch.int32, device=device),
                        opt_block_until=torch.tensor(
                            k + max(opts.check_dual_feas_freq, 1),
                            dtype=torch.int32, device=device),
                    )
                    continue
            final_status = 1
            break

        if st in (5, 6) and not in_cert:
            if opts.certificate_search:
                if cert["entries"] >= _MAX_CERT_SEARCHES:
                    # the searches are spent: the declaration stays unproven
                    final_status, status_string = _unproven_status(budget, k,
                                                                   st)
                    break
                enter_search(st, _declare_string(st, sc))
                continue
            final_status = st
            status_string = _declare_string(st, sc)
            break

        if st == 0 and (k >= budget.max_iter or elapsed >= budget.time_limit):
            if in_cert:  # the search's budget ran out without a ray
                final_status, status_string = _unproven_status(
                    budget, k, cert["mode"])
                break
            lim_status, lim_string = tp.obj(_limit_status(
                sc, state, opts, budget, k, elapsed))
            if lim_status in (5, 6) and opts.certificate_search:
                if cert["entries"] < _MAX_CERT_SEARCHES:
                    enter_search(lim_status, lim_string)
                    continue
                # never an unproven INFEASIBLE / UNBOUNDED
                final_status, status_string = _unproven_status(budget, k,
                                                               lim_status)
                break
            final_status, status_string = lim_status, lim_string
            if opts.warn_on_limit and lim_status in (2, 3):
                print("    WARNING: "
                      + ("Iteration" if lim_status == 3 else "Time")
                      + " limit hit.")
            break

        if in_cert and (k >= budget.hard_cap or elapsed >= budget.time_limit):
            final_status, status_string = _unproven_status(budget, k,
                                                           cert["mode"])
            break

        if k >= budget.hard_cap:
            final_status = 3
            status_string = f"Iteration limit of {budget.max_iter} was hit"
            break

    if tp.sharded:
        tp.check_agreement(checks, "the checksums of x, y and the scalars")
    fields = convert.state_to_numpy(state)
    total_k = int(fields["iter"])
    if cert["found"]:
        # the ray: the search's iterate, its dual slack without c for an
        # infeasibility certificate (solver.py:2284-2296)
        res = _cache_solution(
            fields, setup_h, opts, t0, status=final_status,
            status_string=status_string, zero_c=final_status == 6,
            certificate_found=True, exact_project=big_side, equil=equil,
            square_form=layout.square_form)
    elif cert["mode"]:
        # no ray: the demoted limit status at the best iterate, which is
        # at least as good as the declaration's snapshot (2297-2320)
        if best["snap"] is not None:
            fields.update(best["snap"])
            res = _cache_solution(
                fields, setup_h, opts, t0, status=final_status,
                status_string=status_string or cert["snapshot"].status_string,
                exact_project=big_side, equil=equil,
                square_form=layout.square_form)
            res.iter = k
        else:
            res = cert["snapshot"]
            res.status = final_status
            res.status_string = status_string or res.status_string
            res.time = time.time() - t0
    else:
        if final_status in (2, 3, 4) and best["snap"] is not None:
            cur = max(sc["gap"], sc["feas"])
            if not np.isfinite(cur) or best["score"] < cur:
                fields.update(best["snap"])
        res = _cache_solution(
            fields, setup_h, opts, t0, status=final_status,
            status_string=status_string or STATUS_STRINGS[final_status],
            exact_project=big_side, equil=equil,
            square_form=layout.square_form,
        )
        res.iter = total_k
    res = _annotate_limit_feas(res, setup_h, opts)
    timers["finalize"] = time.time() - t0 - sum(
        v for name, v in timers.items() if name != "finalize")
    if opts.timer_verbose or opts.timer_file:
        report = _timer_report(timers, chunk_counts, res,
                               int(state.proj_fallbacks), fb_ctx)
        if opts.timer_verbose:
            print(report)
        if opts.timer_file:
            with open("time.log", "w") as f:
                f.write(report + "\n")
    if opts.log_verbose:
        _log_final(res)
    return res


def _checksums(state: State) -> list:
    """[sum x, sum x^2, sum y, sum y^2, the sum of every warm start] in
    f64: what the ranks of a tensor-parallel solve compare at every chunk
    end, with their fetched scalars."""
    x, y = state.x.double(), state.y.double()
    warm = sum(w.double().sum() for w in state.warm)
    return torch.stack([x.sum(), (x * x).sum(), y.sum(), (y * y).sum(),
                        warm]).tolist()


def _step_reset(opts: Options, device, tau_p: float, tau_d: float,
                beta: float | None = None) -> dict:
    """f64 step scalars for a restart of the step machinery (the stalled
    hand-over and the polish watchdog, solver.py:1853-1866, 1985-1994)."""

    def f64(v):
        return torch.tensor(v, dtype=torch.float64, device=device)

    kw = dict(primal_step=f64(tau_p), primal_step_old=f64(tau_p),
              dual_step=f64(tau_d), theta=f64(opts.initial_theta),
              adapt_level=f64(opts.initial_adapt_level),
              ada_count=torch.zeros((), dtype=torch.int32, device=device))
    if beta is not None:
        kw["beta"] = f64(beta)
    return kw


def _warm_to_solver(warm_start, setup_h: SetupProblem, layout: ConeLayout,
                    equil) -> tuple:
    """(x, y) in solver space from a Result or an (x, dual_eq, dual_in)
    tuple in user space: the inverse of _cache_solution's unscaling
    (solver.py:1319-1343)."""
    if isinstance(warm_start, Result):
        x_u = warm_start.primal
        y_s = np.concatenate([warm_start.dual_eq, warm_start.dual_in])
    else:
        x_u, y_eq, y_in = warm_start
        y_s = np.concatenate([np.asarray(y_eq, np.float64),
                              np.asarray(y_in, np.float64)])
    x_s = np.asarray(x_u, np.float64)[np.argsort(setup_h.var_ordering)]
    if equil is not None:
        x_s = x_s / equil.D
        y_s = y_s / equil.E
    x_s = _fix_diag_scaling(x_s, setup_h.layout, 1.0 / np.sqrt(2.0))
    x_s = x_s / setup_h.rhs_scale  # user primal -> rhs-scaled primal
    y_s = y_s / setup_h.obj_scale  # user duals -> scaled-objective duals
    if layout.square_form:
        x_s = square_embed_matrix(setup_h.layout) @ x_s
    return x_s, y_s


def _user_duals(state: State, equil, setup_h: SetupProblem) -> np.ndarray:
    """The iterate's duals in user units (solver.py:1714-1717, 2157-2160)."""
    y = state.y.cpu().numpy().astype(np.float64)
    if equil is not None:
        y = equil.E * y
    return y * setup_h.obj_scale


def _declare_string(st, sc):
    if st == 5:
        return f"Unbounded: |Primal objective| = {sc['prim_obj']:.3e} too large"
    return f"Infeasible: detected during iteration (dual objective {sc['dual_obj']:.3e})"


# Certificate searches per solve (solver.py:2563-2569): a failed search
# resumes the solve, so a declare -> search -> fail -> resume cycle is
# capped; three searches cost about one extra solve.
_MAX_CERT_SEARCHES = 3


def _no_search(entries: int) -> dict:
    """The certificate context outside a search, after ``entries``
    searches."""
    return {"snapshot": None, "mode": 0, "found": False, "resume": None,
            "entries": entries}


def _unproven_status(budget: _Budget, k: int, mode: int):
    """An INFEASIBLE / UNBOUNDED declaration without a ray, demoted to the
    limit status with the suspicion in the status string (solver.py:
    2572-2590; the reference keeps 5/6 there, pdhg.jl:228-244)."""
    lim = 3 if k >= budget.max_iter else 2
    suspected = "infeasible" if mode == 6 else "unbounded"
    return lim, (STATUS_STRINGS[lim]
                 + f" [Suspected {suspected}: no certificate found]")


def _enter_certificate_mode(st: int, o: Operands, state: State,
                            budget: _Budget, opts: Options):
    """(operands, state) of the ray search (solver.py:2611-2663, reference
    pdhg.jl:639-676): c zeroed for an infeasibility declaration (6), b and
    h for an unboundedness one (5); a side above 1e3 in max norm (a
    blow-up declaration) scaled to 1, rays being directions; cert_kind and
    the monitoring wait set; the budgets extended in place."""
    if st == 6:
        o = dataclasses.replace(o, c=torch.zeros_like(o.c))
        names = ("y", "y_old", "Mty", "Mty_old", "avg_y", "avg_Mty")
    else:
        o = dataclasses.replace(o, b=torch.zeros_like(o.b),
                                h=torch.zeros_like(o.h))
        names = ("x", "x_old", "Mx", "Mx_old", "avg_x", "avg_Mx")
    side = getattr(state, names[0])
    scale = max(1.0, float(torch.max(torch.abs(side))))
    if scale > 1e3:
        inv = torch.tensor(1.0 / scale, dtype=side.dtype, device=side.device)
        state = state.replace(**{f: getattr(state, f) * inv for f in names})
    k = int(state.iter)
    wait = k + 2 * opts.convergence_window + k // 5 + 1000

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=side.device)

    state = state.replace(cert_kind=i32(st), cert_wait_until=i32(wait),
                          status=i32(0))
    budget.time_limit *= 1.1
    # the reference's +10 % iterations, but at least the monitoring wait
    # and a margin past it (a declaration at the iteration limit)
    budget.max_iter = max(budget.max_iter + budget.max_iter // 10,
                          wait + 2 * opts.convergence_window + 2000)
    budget.hard_cap = max(budget.hard_cap, budget.max_iter + k)
    return o, state


def _clock(opts: Options):
    """The clock of a solve under ``opts``: rank 0's under tensor
    parallelism (``Axis.now``), else this module's ``time.time``."""
    tp = current_tp(opts)
    return tp.now if tp.sharded else time.time


def _set_cert_deadlines(cert: dict, state: State, opts: Options, k: int):
    """One search's deadlines (solver.py:2664-2680): twice its monitoring
    wait in iterations, and 10 % of the time limit clamped to [5, 600] s
    (60 s without a finite limit) on the solve's clock; crossing either
    fails the search."""
    wait = int(state.cert_wait_until)
    cert["deadline_k"] = k + 2 * max(wait - k, 1)
    span_t = 0.1 * opts.time_limit if np.isfinite(opts.time_limit) else 60.0
    cert["deadline_t"] = _clock(opts)() + max(min(span_t, 600.0), 5.0)


def _check_certificate(sc, state: State, setup_h: SetupProblem,
                       opts: Options, mode: int, st: int = 0):
    """(done, found) of the host's ray checks (solver.py:2681-2715,
    reference pdhg.jl:184-244).  Mode 6: a dual ray, b'y above
    certificate_obj_tol with the normalised y dual-feasible for c = 0;
    mode 5: the device's primal-ray flag (status 7), or a primal objective
    below -certificate_obj_tol with the feasibility per unit of it below
    tol_feasibility.  A search whose objectives and feasibility fell below
    -certificate_fail_tol, or whose residual is NaN, failed."""
    if mode == 5 and st == 7:
        return True, True
    if mode == 6:
        if sc["dual_obj"] > opts.certificate_obj_tol:
            y = state.y.cpu().numpy().astype(np.float64) * setup_h.obj_scale
            y_hat = y / max(sc["dual_obj"], 1.0)
            _, dfeas = _dual_cone(y_hat, setup_h, 0.0 * setup_h.c_orig)
            if dfeas < opts.tol_feasibility_dual:
                return True, True
    elif sc["prim_obj"] < -opts.certificate_obj_tol and (
            sc["feas"] / max(abs(sc["prim_obj"]), 1.0) < opts.tol_feasibility):
        return True, True
    ft = opts.certificate_fail_tol
    if (sc["prim_obj"] < -ft and sc["dual_obj"] < -ft and sc["feas"] < -ft) \
            or np.isnan(sc["comb"]):
        return True, False
    return False, False


def _limit_status(sc, state, opts: Options, budget: _Budget, k: int, elapsed: float):
    """Limit-time infeasibility heuristics (reference pdhg.jl:335-378)."""
    buf_gap = state.buf_gap.cpu().numpy()
    stable_gap = float(np.max(np.abs(buf_gap - np.roll(buf_gap, 1))))
    if (
        k > opts.min_iter_time_infeas
        and stable_gap < opts.infeas_stable_gap_tol
        and sc["gap"] > opts.infeas_limit_gap_tol
    ):
        if sc["feas"] <= opts.tol_feasibility / 100:
            return 5, "Problem declared unbounded due to lack of improvement"
        if sc["feas"] > opts.infeas_feasibility_tol:
            return 6, "Problem declared infeasible due to lack of improvement"
    if k >= budget.max_iter:
        return 3, f"Iteration limit of {budget.max_iter} was hit"
    return 2, f"Time limit hit, limit: {budget.time_limit} time: {elapsed}"


def _fix_diag_scaling(x: np.ndarray, layout: ConeLayout, num: float) -> np.ndarray:
    """Divide off-diagonal triangle entries by ``num`` (pdhg.jl:734-743)."""
    x = x.copy()
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        tl = sympackedlen(side)
        x[off : off + tl][offdiag_mask_tri(side)] /= num
    return x


def _cone_feas(v: np.ndarray, layout: ConeLayout) -> float:
    """Max violation of v against the PSD and SOC cones (pdhg.jl:678-699)."""
    viol = 0.0
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        blk = v[off : off + sympackedlen(side)].copy()
        blk[offdiag_mask_tri(side)] /= np.sqrt(2.0)
        if side == 1:
            viol = max(viol, -min(0.0, blk[0]))
        elif not np.all(np.isfinite(blk)):
            viol = np.inf
        else:
            try:
                viol = max(viol, -min(0.0, np.linalg.eigvalsh(ivec(blk)).min()))
            except np.linalg.LinAlgError:
                viol = np.inf
    for off, ln in zip(layout.soc_offsets, layout.soc_lens):
        sblk = v[off : off + ln]
        viol = max(viol, -min(0.0, sblk[0] - np.linalg.norm(sblk[1:])))
    return viol


def _TA(M, y, n):
    if y.size == 0:
        return np.zeros(n)
    return np.asarray(M.T @ y).ravel()


def _dual_cone(y: np.ndarray, setup: SetupProblem, c_used):
    """Dual slack c + A'y_eq + G'y_in and its feasibility violation
    (reference dual_feas, pdhg.jl:712-732)."""
    layout = setup.layout
    p = layout.p
    dual_eq, dual_in = y[:p], y[p:]
    dual_cone = c_used + _TA(setup.A_orig, dual_eq, layout.n) + _TA(
        setup.G_orig, dual_in, layout.n
    )
    dual_cone = _fix_diag_scaling(dual_cone, layout, 2.0)
    ineq_viol = -min(0.0, dual_in.min()) if dual_in.size else 0.0
    tail = dual_cone[layout.cone_dim :]
    zero_viol = np.abs(tail).max() if tail.size else 0.0
    return dual_cone, max(_cone_feas(dual_cone, layout), ineq_viol, zero_viol)


def _annotate_limit_feas(res: Result, setup, opts: Options) -> Result:
    """Flag a constraint-violating best iterate at a limit status
    (solver.py:2716-2746)."""
    if res.status not in (2, 3, 4) or res.primal.size == 0:
        return res
    viol = 0.0
    if res.slack_eq.size:
        viol = float(np.abs(res.slack_eq).max()) / (
            1.0 + float(np.abs(setup.b_orig).max(initial=0.0))
        )
    if res.slack_in.size:
        viol = max(
            viol,
            float(np.maximum(res.slack_in, 0.0).max())
            / (1.0 + float(np.abs(setup.h_orig).max(initial=0.0))),
        )
    if viol > 10 * opts.tol_feasibility and (
        "(infeasible iterate" not in res.status_string
    ):
        res.status_string += f" (infeasible iterate, lin_viol={viol:.1e})"
    return res


def _cache_solution(fields: dict, setup: SetupProblem, opts: Options, t0: float,
                    status: int, status_string: str,
                    exact_project: bool = False,
                    square_form: bool = True, equil=None,
                    zero_c: bool = False,
                    certificate_found: bool = False) -> Result:
    """Unscale, recover duals/slacks, build the Result (pdhg.jl:745-787;
    solver.py:2749-2883).  ``fields`` are host arrays of the square-form
    state (of the packed-triangle state with ``square_form=False``, the
    batch driver's); ``setup`` is the tri-space SetupProblem; ``equil``
    the Equilibration to undo (x D, y E), or None; ``zero_c`` takes the
    dual slack without c (an infeasibility certificate's ray)."""
    layout = setup.layout
    k = int(fields["iter"])
    buf_gap = fields["buf_gap"]
    i = (k - 1) % buf_gap.shape[0]

    x = np.asarray(fields["x"], np.float64)
    y = np.asarray(fields["y"], np.float64)
    if square_form and layout.sdp_sides:
        x = square_embed_matrix(layout).T @ x
    x = _fix_diag_scaling(x, layout, np.sqrt(2.0))
    if equil is not None:  # undo E M D (pdhg.jl:752-755)
        x = equil.D * x
        y = equil.E * y
    x = x * setup.rhs_scale
    y = y * setup.obj_scale

    if exact_project:
        # sides above polar_fallback_min_side: one exact host eigh restores
        # machine-exact cone membership (solver.py:2799-2823)
        for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
            if side == 1:
                x[off] = max(x[off], 0.0)
                continue
            tl = sympackedlen(side)
            iu, ju = tri_ij(side)
            Xm = np.zeros((side, side))
            Xm[iu, ju] = x[off : off + tl]
            Xm[ju, iu] = x[off : off + tl]
            w, V = np.linalg.eigh(Xm)
            if w[0] < -1e-12:
                Xp = (V * np.maximum(w, 0.0)) @ V.T
                x[off : off + tl] = Xp[iu, ju]

    slack_eq = np.asarray(setup.A_orig @ x).ravel() - setup.b_orig
    slack_in = np.asarray(setup.G_orig @ x).ravel() - setup.h_orig
    dual_cone, dual_feasibility = _dual_cone(
        y, setup, 0.0 * setup.c_orig if zero_c else setup.c_orig)

    vo = setup.var_ordering
    sense_mul = -1.0 if setup.objective_sense == "max" else 1.0
    objval = float(fields["buf_prim_obj"][i])
    dual_objval = float(fields["buf_dual_obj"][i])
    gap_out = float(buf_gap[i])
    if exact_project and not zero_c:
        objval = float(np.dot(setup.c_orig, x))
        gap_out = abs(objval - dual_objval) / max(abs(objval), 1.0)

    return Result(
        status=status,
        status_string=status_string,
        primal=x[vo],
        dual_cone=dual_cone[vo],
        dual_eq=y[: layout.p],
        dual_in=y[layout.p :],
        slack_eq=slack_eq,
        slack_in=slack_in,
        primal_residual=float(fields["buf_pres"][i]),
        dual_residual=float(fields["buf_dres"][i]),
        objval=sense_mul * objval + setup.objective_constant,
        dual_objval=sense_mul * dual_objval + setup.objective_constant,
        gap=gap_out,
        time=time.time() - t0,
        iter=k,
        final_rank=int(np.sum(fields["current_rank"])),
        primal_feasible_user_tol=float(fields["buf_feas"][i]) <= opts.tol_feasibility,
        dual_feasible_user_tol=dual_feasibility <= opts.tol_feasibility_dual,
        certificate_found=certificate_found,
        result_count=1,
    )


# ---------------------------------------------------------------------------
# Printing (solver.py:2504-2537, 2886-2950)
# ---------------------------------------------------------------------------


def _timer_report(timers, chunk_counts, res, proj_fallbacks: int, fb_ctx) -> str:
    """Phase-timing report (reference: TimerOutputs print,
    MOI_wrapper.jl:317-330); the race's polar reseeds are split from the
    dense-eigh fallbacks."""
    total = sum(timers.values())
    lines = [
        "-" * 58,
        f"  {'phase':<12} {'time (s)':>10} {'share':>8}   chunks",
        "-" * 58,
    ]
    for name, v in timers.items():
        extra = ""
        if name == "f32 loop":
            extra = f"  {chunk_counts['f32']}"
        elif name == "f64 loop":
            extra = f"  {chunk_counts['f64']}"
        lines.append(f"  {name:<12} {v:>10.3f} {v / max(total, 1e-9):>7.1%}{extra}")
    lines.append("-" * 58)
    tail = f"  total {total:.3f}s  iters={res.iter}"
    if proj_fallbacks >= 0 and res.iter > 0:
        f32_fb = fb_ctx["f32"]
        f64_fb = max(proj_fallbacks - f32_fb, 0)
        if f32_fb and fb_ctx["f32_is_polar"]:
            tail += (f"  proj fallbacks: f32 polar-reseed={f32_fb}, "
                     f"dense-eigh={f64_fb} "
                     f"({f64_fb / max(res.iter, 1):.1%} of iters)")
        else:
            tail += (f"  proj dense-eigh iters={proj_fallbacks}"
                     f" ({proj_fallbacks / max(res.iter, 1):.1%})")
    lines.append(tail)
    return "\n".join(lines)


def _print_header(layout: ConeLayout, opts: Options, device):
    """Banner + problem/parameter summary (reference printing.jl:1-95)."""
    bar = "=" * 74
    print(bar)
    print(f"  proxsdp_tpu_torch — PDHG conic solver  [device: {device}]")
    print(bar)
    print(f"  variables      : {layout.n} (free: {layout.n_free})")
    print(f"  equalities     : {layout.p}    inequalities: {layout.m}")
    if layout.sdp_sides:
        sides = ", ".join(str(s) for s in layout.sdp_sides)
        print(f"  PSD blocks     : {len(layout.sdp_sides)} (sides: {sides})")
    if layout.soc_lens:
        lens = ", ".join(str(s) for s in layout.soc_lens)
        print(f"  SOC blocks     : {len(layout.soc_lens)} (lens: {lens})")
    print(f"  tol_gap={opts.tol_gap:.1e}  tol_feas={opts.tol_feasibility:.1e}  "
          f"tol_psd={opts.tol_psd:.1e}  dtype={opts.dtype}"
          + ("+hybrid" if opts.hybrid_precision and opts.dtype == "float64" else ""))
    print(bar)


def _progress_columns(opts: Options) -> str:
    """Column header for the progress table (reference printing.jl:69-93)."""
    cols = ("    iter        prim obj   rel. gap    feasb.  prim res  "
            "dual res  rank   time(s)")
    if opts.extended_log or opts.extended_log2:
        cols += "    dual obj"
    if opts.extended_log2:
        cols += "   d feasb."
    return cols


def _log_progress(sc, elapsed, opts: Options, dfeas=None):
    """One progress-table row (reference print_progress, printing.jl:96-150);
    extended_log adds the dual objective, extended_log2 the dual
    feasibility ``dfeas``."""
    if opts.log_repeat_header:
        print(_progress_columns(opts))
    row = (
        f"  iter={sc['iter']:>8d}  obj={sc['prim_obj']:+.6e}  "
        f"gap={sc['gap']:.2e}  feas={sc['feas']:.2e}  "
        f"pres={sc['pres']:.2e}  dres={sc['dres']:.2e}  "
        f"rank={sc['sum_target_rank']}  t={elapsed:.1f}s"
    )
    if opts.extended_log or opts.extended_log2:
        row += f"  dobj={sc['dual_obj']:+.6e}"
    if opts.extended_log2:
        row += f"  dfeas={float('nan') if dfeas is None else dfeas:.2e}"
    print(row)


def _log_final(res: Result):
    print("-" * 74)
    print(f"  status: {res.status_string}")
    print(
        f"  obj={res.objval:+.6e}  dual={res.dual_objval:+.6e}  "
        f"gap={res.gap:.2e}  iters={res.iter}  rank={res.final_rank}  "
        f"time={res.time:.2f}s"
    )
    print("-" * 74)
