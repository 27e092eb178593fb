"""PDHG (Chambolle-Pock) solver core -- the port of ``proxsdp_tpu/solver.py``.

One square-form PSD block, in f64 or f32; per iteration

1. ``_primal_step``: kernel K4 (update + symmetrise), the PSD projection
   (``ops.cones``: dense eigh, the polar projection on K5/K6, or the
   subspace step on K7/K8 with a polar or dense fallback), then ``M x``
   (kernel K1 for ELL);
2. ``_linesearch``: the Malitsky-Pock trials, each kernel K2, K1 on M'y and
   the squared distance of K2's file; the host reads one accept flag per
   trial, at most ``max_linsearch_steps`` of them;
3. ``_residuals_and_gap``: kernel K3's nine f64 reductions, the scalar
   formulas in f64, a cast to the program's dtype at the ring writes;
4. ``_control``: the branch-free scalar control with adaptive
   restart-to-average, plain torch on 0-d device tensors (no sync).

The iteration is plain functions on a ``State`` dataclass of tensors.
``solve`` is the host driver (solver.py:1209-2357): the default
``Options()`` runs the hybrid f32 race -> f64 polish with its subspace
entries, watchdog and logging; ``hybrid_precision=False`` one program.
Anything outside the port raises ``NotImplementedError`` naming its
ROADMAP item; nothing falls back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from . import convert, kernels
from .ops.cones import psd_projection_block
from .ops.linop import build_linop, stack_vertical
from .options import Options
from .problem import (
    ConeLayout,
    ConicProblem,
    SetupProblem,
    preprocess,
    square_embed_matrix,
    to_square_form,
)
from .result import STATUS_STRINGS, Result
from .utils.vech import ivec, offdiag_mask_tri, sympackedlen, tri_ij


@dataclasses.dataclass
class Operands:
    """Device problem data.  ``obj_scale`` is SetupProblem.obj_scale *
    rhs_scale (solver.py:1307); the chunk end is an argument of the chunk
    runner, not a field."""

    M: nn.Module  # DenseOp | EllOp for [A; G]
    b: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    norm_b: torch.Tensor  # 0-d
    norm_h: torch.Tensor
    norm_c: torch.Tensor
    obj_scale: torch.Tensor


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


def init_state(layout: ConeLayout, opts: Options, setup: SetupProblem) -> dict:
    """Initial solver state as a dict of NumPy arrays (solver.py:158-278,
    cold start) in ``opts.dtype``, with an orthonormal (side, k) start
    basis for a subspace program; ``convert.state_from_numpy`` moves it to
    a device."""
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

    x0 = (step * setup.c).astype(dtype) if opts.advanced_initialization else z(n)
    y0 = z(pm)
    Mx0 = np.asarray(M_host @ x0, dtype=dtype).ravel() if pm else z(pm)
    Mty0 = z(n)

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
        x_old=z(n),
        y=y0,
        y_old=y0.copy(),
        Mx=Mx0,
        Mx_old=z(pm),
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


def _primal_step(s: State, o: Operands, layout: ConeLayout, opts: Options,
                 k: int):
    """x <- proj_K(x - tau*(M'y + c)); Mx <- M x (pdhg.jl:611-637).

    ``k`` is the iteration count before the step (the host knows it): the
    subspace program's forced reseed pulse is a host flag."""
    side = layout.sdp_sides[0]
    u = kernels.primal_update_sym(s.x, s.Mty, o.c, s.primal_step, side)
    s2 = side * side
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
    res = psd_projection_block(u[:s2].view(side, side), s.warm[0], opts=opts,
                               accept_tol=accept_tol, force_full=force_full)
    x = res.block.reshape(-1)
    if s2 < u.shape[0]:
        x = torch.cat([x, u[s2:]])
    return s.replace(
        x=x,
        Mx=o.M.matvec(x),
        min_eig=res.min_eig.reshape(1).to(s.min_eig.dtype),
        current_rank=res.current_rank.reshape(1),
        warm=(res.warm,),
        proj_fallbacks=s.proj_fallbacks + 1 if res.used_full else s.proj_fallbacks,
        sub_stats=res.sub_stats,
        sub_worst=torch.maximum(s.sub_worst, res.sub_stats[0]),
    )


def _linesearch(s: State, o: Operands, layout: ConeLayout, opts: Options):
    """Malitsky-Pock backtracking dual step (pdhg.jl:532-582).

    The trial loop runs on the host: each trial is K2, K1 (M'y_temp) and
    the squared distance, then one read of the accept flag."""
    p, m = layout.p, layout.m
    ps = s.primal_step * torch.sqrt(1.0 + s.theta)
    sqrt_beta = torch.sqrt(s.beta)
    theta = s.theta
    y_temp = torch.zeros_like(s.y)
    Mty = torch.zeros_like(s.Mty)
    for _ in range(opts.max_linsearch_steps):
        theta = ps / s.primal_step_old
        bp = s.beta * ps
        y_temp, dy = kernels.ls_dual_update(
            s.y, s.Mx, s.Mx_old, o.b, o.h, s.y_old, bp, theta, p, m
        )
        Mty = o.M.rmatvec(y_temp)
        dM = kernels.sq_dist(Mty, s.Mty_old)
        ok = sqrt_beta * ps * torch.sqrt(dM) <= opts.delta * torch.sqrt(dy)
        if bool(ok):
            break
        ps = ps * opts.linsearch_decay
    return s.replace(
        y=y_temp,
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
        r = kernels.residuals(*args, layout.sdp_sides[0])
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

    blk_conv = (
        (sides_arr < opts.min_size_krylov_eigs)
        | (s.target_rank > opts.max_target_rank_krylov_eigs)
        | (s.min_eig < opts.tol_psd)
    )
    rank_conv = torch.all(blk_conv, dim=-1)

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
    any_not_full = torch.any(s.target_rank < sides_arr, dim=-1)
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
    iteration.  ``fetch(s)`` returns the 14 host-monitored scalars as one
    NumPy array (one device-to-host copy)."""
    _check_slice_layout(layout, opts)
    sides_arr = torch.tensor(layout.sdp_sides, dtype=torch.int32, device=device)

    def iteration(s: State, o: Operands, k: int | None = None) -> State:
        # k: the iteration count s.iter, when the caller knows it (else
        # read from the device)
        s = _primal_step(s, o, layout, opts, int(s.iter) if k is None else k)
        if opts.line_search_flag:
            s = _linesearch(s, o, layout, opts)
        else:
            s = _dual_step(s, o, layout, opts)
        s = _residuals_and_gap(s, o, layout, opts)
        return _control(s, o, layout, opts, sides_arr)

    def run_chunk(s: State, o: Operands, chunk_end: int) -> State:
        k = int(s.iter)
        while k < chunk_end:
            s = iteration(s, o, k)
            k += 1
            if int(s.status) != 0:
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


# ---------------------------------------------------------------------------
# What the slice supports
# ---------------------------------------------------------------------------


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def _check_slice_options(opts: Options) -> None:
    if opts.subspace_sign:
        _unsupported("subspace_sign=True (the sign-based subspace body)",
                     "B5 (_subspace_body_sign)")
    if opts.subspace_accept_always:
        _unsupported("subspace_accept_always=True (the batch mode)", "B13")
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
    if not opts.square_form:
        _unsupported("square_form=False", "A7 / B12")


def _check_slice_layout(layout: ConeLayout, opts: Options) -> None:
    if layout.soc_lens:
        _unsupported("SOC blocks", "A7 / B3'")
    if len(layout.sdp_sides) != 1:
        _unsupported("problems without exactly one PSD block "
                     "(multi-block, grouped small blocks, LPs)", "A7 / B11")
    if not layout.square_form:
        _unsupported("the packed-triangle layout", "A7 / B12")
    side = layout.sdp_sides[0]
    if (not opts.full_eig_decomp and opts.use_lanczos
            and side > opts.min_size_krylov_eigs
            and side > opts.full_eig_max_side):
        _unsupported(f"the Lanczos projection (side {side} > "
                     f"full_eig_max_side)", "A8 / B10")


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
    k_bucket == 0 means the observed rank is too large for subspace mode."""
    x_host = state.x.cpu().numpy().astype(np.float64) - float(state.primal_step) * (
        state.Mty.cpu().numpy().astype(np.float64) + np.asarray(c_host, np.float64)
    )
    specs = []
    for off, side in zip(layout.sdp_offsets, layout.sdp_sides):
        Xm = x_host[off : off + side * side].reshape(side, side)
        Xm = 0.5 * (Xm + Xm.T)
        w, V = np.linalg.eigh(Xm)
        lam_max = max(float(w[-1]), 0.0)
        r_blk = int(np.sum(w > max(opts.tol_psd, 1e-4 * max(lam_max, 1e-12))))
        specs.append((side, V, r_blk))
    r_obs = max(r for _, _, r in specs)
    k = _sub_bucket(r_obs + opts.polish_subspace_guard)
    if not (k and any(k < side // 2 for side in layout.sdp_sides)):
        return 0, r_obs, specs
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


def solve(problem, options: Options | None = None, *, device="cuda",
          **kwargs) -> Result:
    """Solve a ConicProblem (or a preprocessed SetupProblem) on ``device``.

    The host driver of solver.py:1209-2357.  Under the default
    ``Options()`` (f64 with ``hybrid_precision``) an f32 race runs first --
    the polar projection, then from ``race_subspace_warmup`` on the f32
    subspace step with a polar reseed -- and hands over to an f64 polish on
    the mixed-precision subspace step, which alone may declare OPTIMAL;
    ``hybrid_precision=False`` runs one program.  Also: the iteration and
    time limits, best-iterate tracking, the polish watchdog (guarded step
    restart, subspace re-estimate), limit statuses, logging, the timer
    report and solution recovery.  ``device`` defaults to the CUDA card;
    without one it raises (pass ``device="cpu"`` for the plain PyTorch
    path).  Library products run in IEEE f32 whatever the caller's
    float32 matmul precision.
    """
    with _ieee_f32_products():
        return _solve(problem, options, device, kwargs)


def _solve(problem, options: Options | None, device, kwargs) -> Result:
    opts = options or Options()
    if kwargs:
        opts = opts.replace(**kwargs)
    _check_slice_options(opts)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "solve: no CUDA card is available (torch.cuda.is_available() is "
            "false); pass device='cpu' for the plain PyTorch path")

    t0 = time.time()
    setup = (
        preprocess(problem, scale_objective=opts.scale_objective,
                   scale_rhs=opts.scale_rhs)
        if isinstance(problem, ConicProblem)
        else problem
    )
    if opts.log_verbose:
        _print_header(setup.layout, opts, device)
    if opts.block_equilibration == "auto":
        # the probe race (solver.py:1249-1257) or the static gate (1267-1268)
        spread = _row_norm_spread(setup)
        probe = (opts.block_equilibration_probe_spread > 0
                 and isinstance(problem, ConicProblem)
                 and spread > opts.block_equilibration_probe_spread)
        if probe or spread > opts.block_equilibration_spread:
            _unsupported("block equilibration and its 'auto' probe (row-norm "
                         f"spread {spread:.3g} above the gate)", "A6")

    setup_h = setup
    setup = to_square_form(setup)
    layout = setup.layout

    def make_operands(dt):
        M = build_linop(setup.A, setup.G, dt, device=device,
                        force=None if opts.linop == "auto" else opts.linop)
        return convert.operands_from_numpy(
            M=M, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
            norm_h=setup.norm_h, norm_c=setup.norm_c,
            obj_scale=setup.obj_scale * setup.rhs_scale, device=device,
            dtype=dt,
        )

    def runner(po: Options):
        run, _, fetch_ = make_chunk_runner(layout, po, device=device)
        return run, fetch_

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
        state = convert.state_from_numpy(init_state(layout, opts32, setup),
                                         device)
        phase32 = True
    else:
        state = convert.state_from_numpy(init_state(layout, opts, setup), device)
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
    big_side = max(layout.sdp_sides) > min(opts.full_eig_max_side,
                                           opts.polar_fallback_min_side)
    polish_fb = {"subspace_fallback": "polar"} if big_side else {}

    budget = _Budget(opts, True)
    chunk = opts.chunk_iters or DEFAULT_CHUNK
    log_next = opts.log_freq
    stall_window = max(3 * opts.convergence_window, 1500)
    hybrid_best = {"value": float("inf"), "since": 0}
    # best iterate by max(gap, feas), snapshot at most every 2 s
    best = {"score": float("inf"), "snap": None, "t": t0}
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

    while True:
        k0 = int(state.iter)
        step_n = 1 if (time.time() - t0) >= budget.time_limit else chunk
        target = min(k0 + step_n, budget.max_iter)
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
        sc = {name: int(x) if name in _INT_SCALARS else float(x)
              for name, x in zip(_SCALARS, v)}
        timers["host sync"] += time.time() - t_sync
        k, st = sc["iter"], sc["status"]
        elapsed = time.time() - t0

        if k > 0:
            score = max(sc["gap"], sc["feas"])
            if (np.isfinite(score) and score < 0.95 * best["score"]
                    and time.time() - best["t"] >= 2.0):
                t_snap = time.time()
                best["t"] = t_snap
                best["score"] = score
                host = convert.state_to_numpy(state)
                best["snap"] = {f: host[f] for f in _SNAP_FIELDS}
                timers["snapshot"] += time.time() - t_snap

        if opts.log_verbose and k >= log_next:
            _log_progress(sc, elapsed, opts)
            log_next += opts.log_freq

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
                    fresh = init_state(layout, opts, setup)
                    fresh["iter"] = np.int32(k)
                    state = convert.state_from_numpy(fresh, device)
                    continue
                state = _cast_state(state, torch.float64)
                entered_polish = False
                if opts.polish_subspace and opts.subspace_rank == 0:
                    k_sub, r_obs, specs = _estimate_subspace(state, layout,
                                                             opts, setup.c)
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
                        and state.warm[0].dim() == 2):
                    state = _collapse_warm(state)
                if stalled:
                    # the race wedged its step machinery: restart the steps
                    # at the hand-over, keeping the iterates
                    state = state.replace(**_step_reset(
                        opts, device, tau0, tau0, beta=opts.initial_beta))
            elif (opts.race_subspace and not sub32["entered"]
                  and sub32["tries"] < 5 and opts.subspace_rank == 0
                  and k >= sub32["retry_at"]):
                # past the cold start: size an f32 subspace program from the
                # observed rank and seed it with the exact top-k basis
                sub32["tries"] += 1
                k_sub, r_obs, specs = _estimate_subspace(state, layout, opts,
                                                         setup.c)
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

        # guarded-restart rollback: a step restart that blew the metric up
        # (or led to a 5/6 declaration) within one chunk is undone and
        # further restarts are suppressed (solver.py:1909-1944)
        g = polish["guard"]
        if g is not None and k > g[2]:
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
        if st == 0 and sc["gap"] > opts.tol_gap:
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
                    k_new, r_obs, specs = _estimate_subspace(state, layout,
                                                             opts, setup.c)
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

        if st == 1:
            if opts.check_dual_feas:
                y_now = convert.state_to_numpy(state)["y"] * setup_h.obj_scale
                _, dfeas = _dual_cone(y_now, setup_h, setup_h.c_orig)
                if dfeas >= opts.tol_feasibility_dual:
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

        if st in (5, 6):
            if opts.certificate_search:
                _unsupported("the status 5/6 certificate search (pass "
                             "certificate_search=False to return the "
                             "declaration)", "A4 (certificates)")
            final_status = st
            status_string = _declare_string(st, sc)
            break

        if st == 0 and (k >= budget.max_iter or elapsed >= budget.time_limit):
            lim_status, lim_string = _limit_status(sc, state, opts, budget, k,
                                                   elapsed)
            if lim_status in (5, 6) and opts.certificate_search:
                _unsupported("the limit-time certificate search",
                             "A4 (certificates)")
            final_status, status_string = lim_status, lim_string
            if opts.warn_on_limit and lim_status in (2, 3):
                print("    WARNING: "
                      + ("Iteration" if lim_status == 3 else "Time")
                      + " limit hit.")
            break

        if k >= budget.hard_cap:
            final_status = 3
            status_string = f"Iteration limit of {budget.max_iter} was hit"
            break

    fields = convert.state_to_numpy(state)
    total_k = int(fields["iter"])
    if final_status in (2, 3, 4) and best["snap"] is not None:
        cur = max(sc["gap"], sc["feas"])
        if not np.isfinite(cur) or best["score"] < cur:
            fields.update(best["snap"])
    res = _cache_solution(
        fields, setup_h, opts, t0, status=final_status,
        status_string=status_string or STATUS_STRINGS[final_status],
        exact_project=big_side,
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


def _declare_string(st, sc):
    if st == 5:
        return f"Unbounded: |Primal objective| = {sc['prim_obj']:.3e} too large"
    return f"Infeasible: detected during iteration (dual objective {sc['dual_obj']:.3e})"


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
    """Max violation of v against the PSD cones (pdhg.jl:678-699)."""
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
                    square_form: bool = True) -> Result:
    """Unscale, recover duals/slacks, build the Result (pdhg.jl:745-787;
    solver.py:2749-2883).  ``fields`` are host arrays of the square-form
    state (of the packed-triangle state with ``square_form=False``, the
    batch driver's); ``setup`` is the tri-space SetupProblem."""
    layout = setup.layout
    k = int(fields["iter"])
    buf_gap = fields["buf_gap"]
    i = (k - 1) % buf_gap.shape[0]

    x = np.asarray(fields["x"], np.float64)
    if square_form:
        x = square_embed_matrix(layout).T @ x
    x = _fix_diag_scaling(x, layout, np.sqrt(2.0))
    x = x * setup.rhs_scale
    y = np.asarray(fields["y"], np.float64) * setup.obj_scale

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
    dual_cone, dual_feasibility = _dual_cone(y, setup, setup.c_orig)

    vo = setup.var_ordering
    sense_mul = -1.0 if setup.objective_sense == "max" else 1.0
    objval = float(fields["buf_prim_obj"][i])
    dual_objval = float(fields["buf_dual_obj"][i])
    gap_out = float(buf_gap[i])
    if exact_project:
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
        certificate_found=False,
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


def _log_progress(sc, elapsed, opts: Options):
    """One progress-table row (reference print_progress, printing.jl:96-150);
    extended_log adds the dual objective.  The dual-feasibility column of
    extended_log2 is not computed here (nan)."""
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
        row += f"  dfeas={float('nan'):.2e}"
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
