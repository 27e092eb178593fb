"""K19 (the iteration's control), K20 (the restart-to-average) and K21
(the batch's masked freeze): wrappers and plain twins.

One iteration's scalar tail runs, on a CUDA state, as

    K3 (pass 1: partials)  ->  K20a  ->  K19  ->  K20b

``restart_average`` (K20a, ``csrc/restart_avg.cu``) forms the new
running sums avg_x, avg_y, avg_Mx, avg_Mty (+ tau v) and, in the same
pass, the reductions of the restart's decision over the average
x_bar = avg / clamp_min(avg_w + tau, 1e-30): c . x_bar, b . y_bar[:p],
h . y_bar[p:], max |M x_bar[:p] - b| and max (M x_bar[p:] - h).
``control`` (K19, ``csrc/control.cu``) folds K3's and K20a's partials,
takes the residual formulas of ``_residuals_and_gap`` in f64, writes the
seven rings at ``iter % L`` and runs every decision of ``_control``:
status, rank bumps, step balance, infeasibility and ray tests, the
restart's epoch and ``stalled``.  ``restart_adopt`` (K20b) puts the
average in place of the iterate where ``stalled`` holds and zeroes the
sums there.  ``restart="none"`` launches neither K20 entry point.

Every output is a fresh tensor (as the plain twins' are): the rings, the
counters and the steps of one call are views of its output buffers (the
rings, the program-dtype scalars, the int32 scalars, the target ranks).  Nothing is written in place, since a
batch step keeps its input state for the freeze.

``freeze_rows`` (K21, ``csrc/freeze_rows.cu``) is the batch's masked
freeze: out[b] = mask[b] ? new[b] : old[b] over every pair of fields in
one launch.

A runner calls K20a, K19 and K20b through one ``ControlStep`` (made by
``solver.make_chunk_runner`` and the batch's runner): its ControlConfig
and block sides, and per state geometry the argument checks and entry
points, made once, so a call fills in the data pointers and launches.
``control``, ``restart_average`` and ``restart_adopt`` are the same
launches with their checks on every call.

On the CPU each wrapper runs its plain twin (today's torch code of
``solver._residuals_and_gap``, ``solver._control`` and
``parallel.batch._where_rows``, moved here); on a CUDA tensor it launches
its kernel or raises ``KernelError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import (RESIDUAL_SLOTS, _call, _entry, _launch, _on_cpu, _ptr,
               _reduce_grid)

# ------------------------------------------------------------ shared helpers
# (the single-instance State has 0-d scalars and (L,) rings; the batched
# one (B,) scalars and (B, L) rings: these take either)


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


def _bump_ranks(target, current, min_eig, sides_arr, opts):
    """Adaptive target-rank increment (pdhg.jl:270-280, 289-303)."""
    eligible = ((current + opts.rank_slack) >= target) & (min_eig > opts.tol_psd)
    if opts.rank_increment == 0:
        new = target * opts.rank_increment_factor
    else:
        new = target + opts.rank_increment_factor
    return torch.where(eligible, torch.minimum(new, sides_arr), target)


# ---------------------------------------------------------- configuration

# the rings in K19's order (control.cu: enum Ring)
RINGS = ("buf_gap", "buf_prim_obj", "buf_dual_obj", "buf_feas", "buf_pres",
         "buf_dres", "buf_comb")
# K19's outputs of the program's dtype (control.cu: enum TOut) and int32
# (enum IOut), each a row of its buffer
T_OUT = ("equa_feas", "ineq_feas", "beta", "primal_step", "dual_step",
         "adapt_level", "avg_w", "last_restart_gap", "wsum")
I_OUT = ("status", "rank_update", "update_cont", "ada_count", "iter",
         "last_restart_iter", "stalled")
RESTART_SLOTS = 5  # K20a's reductions


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """What K19 and its twin need of a runner's layout and options; built
    once per runner (``control_config``).  ``ints`` and ``doubles`` are
    control.cu's ``Consts`` in its order: every float constant is the
    double the torch code compares or multiplies with, cast to the
    program's dtype in the kernel as torch casts a Python float."""

    opts: object
    p: int
    m: int
    n_tri: int
    has_sdp: bool
    has_soc: bool

    @functools.cached_property
    def ints(self):
        o = self.opts
        factor = o.rank_increment_factor
        if int(factor) != factor:
            raise ValueError("control: rank_increment_factor must be an "
                             f"integer, got {factor!r}")
        vals = (o.convergence_window, self.p, self.m, self.has_sdp,
                self.has_soc, o.line_search_flag, o.step_balance == "ratio",
                o.restart == "adaptive", o.restart_trigger == "kkt",
                o.rank_increment == 0, int(factor), o.min_size_krylov_eigs,
                o.max_target_rank_krylov_eigs, o.min_iter,
                o.divergence_min_update, o.adapt_window, o.min_iter_max_obj,
                o.restart_window, o.rank_slack)
        return (ctypes.c_int64 * len(vals))(*(int(v) for v in vals))

    @functools.cached_property
    def doubles(self):
        o = self.opts
        vals = (math.sqrt(float(self.n_tri)), math.sqrt(float(self.p + self.m)),
                o.tol_psd, o.tol_soc, o.tol_gap, o.tol_feasibility,
                o.step_balance_ratio, o.tol_primal, o.tol_dual, o.adapt_decay,
                o.max_obj, o.infeas_limit_gap_tol, o.infeas_feasibility_tol,
                o.infeas_stable_feasibility_tol, 1.0 - o.infeas_gap_tol,
                o.infeas_stable_gap_tol, o.certificate_obj_tol,
                min(o.tol_gap, o.tol_feasibility), o.restart_decay)
        return (ctypes.c_double * len(vals))(*(float(v) for v in vals))


@functools.lru_cache(maxsize=64)
def control_config(layout, opts) -> ControlConfig:
    return ControlConfig(opts, layout.p, layout.m, layout.n_tri,
                         bool(layout.sdp_sides), bool(layout.soc_lens))


# ------------------------------------------------ K19 plain twin (control)


def _formulas_plain(s, o, cfg: ControlConfig, r):
    """The scalar formulas of _residuals_and_gap (solver.py:563-612) in
    f64 from K3's nine values, and the ring writes in the program's
    dtype (an f32 program casts there, as the JAX f32 program does)."""
    p, m = cfg.p, cfg.m
    L = s.buf_gap.shape[-1]
    idx = torch.remainder(s.iter, L)  # (k - 1) % L with k = iter + 1
    r = r.unbind(-1)
    norm_b, norm_h, norm_c = o.norm_b.double(), o.norm_h.double(), o.norm_c.double()
    # primal PPA residual (sqrt of the tri-equivalent coordinate count,
    # residuals.jl:46-55)
    pres = (
        math.sqrt(float(cfg.n_tri)) * r[0]
        / torch.clamp_min(torch.maximum(r[1], torch.maximum(norm_b, norm_h)), 1.0)
    )
    dres = (
        math.sqrt(float(p + m)) * r[2]
        / torch.clamp_min(torch.maximum(r[3], norm_c), 1.0)
    )
    comb = torch.maximum(pres, dres)
    zero = torch.zeros(s.iter.shape, dtype=torch.float64, device=s.iter.device)
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
                     ineq], dim=-1).to(s.buf_gap.dtype).unbind(-1)
    return dict(
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


def _decisions_plain(s, o, cfg: ControlConfig, sides_arr, red):
    """Convergence / rank-update / divergence / adaptive-step branching,
    in-loop infeasibility detection (pdhg.jl:246-332, 390-483) and the
    restart's decision (solver.py:653-911) on a state whose rings hold
    this iteration's values.  Returns (updates, stalled, wsum); stalled
    and wsum are None without the adaptive restart."""
    opts = cfg.opts
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

    if cfg.has_sdp:
        blk_conv = (
            (sides_arr < opts.min_size_krylov_eigs)
            | (s.target_rank > opts.max_target_rank_krylov_eigs)
            | (s.min_eig < opts.tol_psd)
        )
        rank_conv = torch.all(blk_conv, dim=-1)
    else:
        rank_conv = torch.ones_like(active)
    if cfg.has_soc:  # the SOC gap of the projection (solver.py:689-691)
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
                    if cfg.has_sdp else torch.zeros_like(active))
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

    upd = dict(
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
    )
    if opts.restart != "adaptive":
        return upd, None, None
    p, m = cfg.p, cfg.m
    ps = s.primal_step
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
    # K20a's reductions over the average: red[..., 0] = c . x_bar, 1 = b .
    # y_bar[:p], 2 = h . y_bar[p:], 3 = max |M x_bar[:p] - b|, 4 = max
    # (M x_bar[p:] - h)
    po_a = red[..., 0] * o.obj_scale
    do_a = torch.zeros_like(po_a)
    if p:
        do_a = do_a - red[..., 1]
    if m:
        do_a = do_a - red[..., 2]
    do_a = do_a * o.obj_scale
    gap_a = torch.abs(po_a - do_a) / (1.0 + torch.abs(po_a) + torch.abs(do_a))
    feas_a = torch.zeros_like(gap_a)
    if p:
        feas_a = torch.maximum(feas_a, red[..., 3] / (1.0 + o.norm_b))
    if m:
        feas_a = torch.maximum(feas_a, red[..., 4] / (1.0 + o.norm_h))
    metric_now = torch.maximum(gap_k, feas_k)
    metric_avg = torch.maximum(gap_a, feas_a)
    stalled = stalled & (metric_avg < 0.9 * metric_now)
    keep = (~stalled).to(avg_w.dtype)
    upd.update(
        avg_w=avg_w * keep,
        last_restart_iter=torch.where(epoch, k, s.last_restart_iter),
        last_restart_gap=torch.where(epoch, metric_k, s.last_restart_gap),
    )
    return upd, stalled, wsum


def control_plain(s, o, cfg: ControlConfig, sides_arr, r=None, red=None,
                  control: bool = True):
    """K19's plain twin on a State ``s`` (0-d scalars, or a batch's (B,)
    ones) and Operands ``o``: with ``r`` (K3's nine f64 values, (9,) or
    (B, 9)) the residual formulas and ring writes; with ``control`` the
    decisions on the state with those rings (``red``: K20a's (5,) or
    (B, 5) reductions, for the adaptive restart).  Returns (the updated
    fields, stalled, wsum); stalled (bool; int32 from the kernel) and
    wsum are None without the adaptive restart or ``control``."""
    upd = {}
    if r is not None:
        upd = _formulas_plain(s, o, cfg, r)
    if not control:
        return upd, None, None
    dec, stalled, wsum = _decisions_plain(s.replace(**upd) if upd else s, o,
                                          cfg, sides_arr, red)
    upd.update(dec)
    return upd, stalled, wsum


# ------------------------------------------------------ K19 (control.cu)

CONTROL_THREADS = 256  # control.cu: the single entry's CTA, the batch's 8 warps


def _scalar_fields(s, o):
    """K19's program-dtype inputs after the rings, in control.cu's order
    (enum Ptr, kEquaIn..kObjScale)."""
    return (s.equa_feas, s.ineq_feas, s.beta, s.primal_step, s.dual_step,
            s.adapt_level, s.min_eig, s.max_soc_gap, s.avg_w,
            s.last_restart_gap, o.norm_b, o.norm_h, o.norm_c, o.obj_scale)


def _int_fields(s, sides_arr):
    """K19's int32 inputs (enum Ptr, kIter..kSides)."""
    return (s.iter, s.status, s.rank_update, s.update_cont, s.ada_count,
            s.target_rank, s.current_rank, s.cert_kind, s.cert_wait_until,
            s.infeas_block_until, s.opt_block_until, s.last_restart_iter,
            sides_arr)


def _data_ptrs(tensors, keep: list) -> list:
    """Each tensor's data pointer; a non-contiguous one (a state built
    elsewhere) is copied, and the copy kept in ``keep`` until the launch
    is queued."""
    out = []
    for t in tensors:
        if not t.is_contiguous():
            t = t.contiguous()
            keep.append(t)
        out.append(t.data_ptr())
    return out


def _check_control(name, s, o, sides_arr, r, red, batched, adaptive,
                   control):
    """K19's argument checks (device, dtypes, shapes); returns the
    geometry (B, L, nb)."""
    if control and adaptive and red is None:
        raise ValueError(f"{name}: the adaptive restart needs K20a's reductions")
    fields = _scalar_fields(s, o)
    dt, dev = s.buf_gap.dtype, s.buf_gap.device
    B = s.iter.shape[0] if batched else 1
    L = s.buf_gap.shape[-1]
    nb = s.target_rank.shape[-1]
    bshape = (B,) if batched else ()
    for t in _int_fields(s, sides_arr):
        if t.dtype != torch.int32 or t.device != dev:
            raise TypeError(f"{name}: counters must be int32 on {dev}")
    for t in fields:
        if t.dtype != dt:
            raise TypeError(f"{name}: every float field must be {dt}")
    for t in (*fields[:6], *fields[7:], s.iter, s.status, s.rank_update,
              s.update_cont, s.ada_count, s.cert_kind, s.cert_wait_until,
              s.infeas_block_until, s.opt_block_until, s.last_restart_iter):
        if tuple(t.shape) != bshape:
            raise ValueError(f"{name}: a scalar field of shape "
                             f"{tuple(t.shape)}, want {bshape}")
    for f in RINGS:
        if tuple(getattr(s, f).shape) != bshape + (L,):
            raise ValueError(f"{name}: rings of differing shapes")
    for t in (s.target_rank, s.current_rank, s.min_eig):
        if tuple(t.shape) != bshape + (nb,):
            raise ValueError(f"{name}: per-block fields must be {bshape + (nb,)}")
    if sides_arr.shape != (nb,):
        raise ValueError(f"{name}: sides_arr has shape "
                         f"{tuple(sides_arr.shape)}, want ({nb},)")
    for t, k, what in ((r, RESIDUAL_SLOTS, "r"), (red, RESTART_SLOTS, "red")):
        if t is not None and (t.device != dev or t.dim() != 2
                              or t.shape[1] != k or t.dtype != torch.float64
                              or (batched and t.shape[0] != B)):
            raise ValueError(f"{name}: {what} of shape {tuple(t.shape)} "
                             f"({t.dtype}), want f64 (P, {k})"
                             + (f" with P = {B}" if batched else ""))
    return B, L, nb


def _check_restart_average(name, args, p, m, batched):
    x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty, avg_w, ps, c, b, h = args
    B = x.shape[0] if batched else 1
    n, pm = x.shape[-1], y.shape[-1]
    bshape = (B,) if batched else ()
    for t, k, what in ((x, n, "x"), (Mty, n, "Mty"), (avg_x, n, "avg_x"),
                       (avg_Mty, n, "avg_Mty"), (c, n, "c"), (y, pm, "y"),
                       (Mx, pm, "Mx"), (avg_y, pm, "avg_y"),
                       (avg_Mx, pm, "avg_Mx"), (b, p, "b"), (h, m, "h")):
        if tuple(t.shape) != bshape + (k,):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}")
    if p + m != pm or tuple(avg_w.shape) != bshape or tuple(ps.shape) != bshape:
        raise ValueError(f"{name}: bad shapes")
    return B, n, pm


def _check_restart_adopt(name, args, batched):
    x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty, stalled, wsum = args
    B = x.shape[0] if batched else 1
    bshape = (B,) if batched else ()
    if (tuple(stalled.shape) != bshape or tuple(wsum.shape) != bshape
            or Mty.shape != x.shape or avg_x.shape != x.shape
            or avg_Mty.shape != x.shape or Mx.shape != y.shape
            or avg_y.shape != y.shape or avg_Mx.shape != y.shape):
        raise ValueError(f"{name}: bad shapes")
    if stalled.device != x.device or stalled.dtype not in (torch.int32,
                                                           torch.bool):
        raise ValueError(f"{name}: stalled must be int32 or bool on "
                         f"{x.device}")
    return B, x.shape[-1], y.shape[-1]


class ControlStep:
    """K20a, K19 and K20b of one runner: its ControlConfig and block sides
    (int32, (1,) without PSD blocks), made once by
    ``solver.make_chunk_runner`` and the batch's runner.  On the card the
    first call of a state's geometry (entry point, dtype, device, batch,
    lengths, partial rows) checks the arguments and resolves the entry
    point; later calls of that geometry fill in the data pointers and
    launch.  On the CPU each method runs its plain twin."""

    def __init__(self, cfg: ControlConfig, sides_arr):
        self.cfg = cfg
        self.sides_arr = sides_arr
        self._plans = {}

    # -------------------------------------------------------------- K19
    def control(self, s, o, r=None, red=None, control: bool = True):
        """``control_plain`` as one launch of K19.  On the card ``r`` may
        be K3's pass-1 partials ((P, 9) f64, ``residuals(fold=False)``)
        and ``red`` K20a's ((P, 5) f64), which K19 folds in reduce.cuh's
        fixed order; a batch passes (B, 9) and (B, 5)."""
        cfg, sides_arr = self.cfg, self.sides_arr
        batched = s.iter.dim() == 1
        name = "control_batch" if batched else "control"
        adaptive = cfg.opts.restart == "adaptive"
        if not (adaptive and control):
            red = None
        dev = s.buf_gap.device
        if dev.type != "cuda":
            _on_cpu(name, *(getattr(s, f) for f in RINGS),
                    *_scalar_fields(s, o), *((r,) if r is not None else ()),
                    *((red,) if red is not None else ()), mixed=True,
                    strided=True)
            return control_plain(s, o, cfg, sides_arr, r, red, control)
        dt = s.buf_gap.dtype
        key = (name, dt, dev, tuple(s.buf_gap.shape), s.target_rank.shape[-1],
               None if r is None else tuple(r.shape),
               None if red is None else tuple(red.shape), control)
        plan = self._plans.get(key)
        if plan is None:
            _on_cpu(name, *(getattr(s, f) for f in RINGS),
                    *_scalar_fields(s, o), *((r,) if r is not None else ()),
                    *((red,) if red is not None else ()), mixed=True,
                    strided=True)
            geom = _check_control(name, s, o, sides_arr, r, red, batched,
                                  adaptive, control)
            plan = self._plans[key] = (_entry(name, dt), *geom)
        entry, B, L, nb = plan
        bshape = (B,) if batched else ()
        ring_out = (torch.empty((len(RINGS),) + bshape + (L,), dtype=dt,
                                device=dev) if r is not None else None)
        t_out = torch.empty((len(T_OUT),) + bshape, dtype=dt, device=dev)
        i_out = torch.empty((len(I_OUT),) + bshape, dtype=torch.int32,
                            device=dev)
        target_out = (torch.empty(bshape + (nb,), dtype=torch.int32,
                                  device=dev) if control else None)
        keep = []
        ptrs = _data_ptrs((*(getattr(s, f) for f in RINGS),
                           *_scalar_fields(s, o), *_int_fields(s, sides_arr)),
                          keep)
        for t in (r, red, ring_out):
            ptrs += [None] if t is None else _data_ptrs((t,), keep)
        ptrs += [t_out.data_ptr(), i_out.data_ptr(),
                 None if target_out is None else target_out.data_ptr()]
        table = (ctypes.c_void_p * len(ptrs))(*ptrs)
        _call(entry, dev, ctypes.addressof(table), len(ptrs),
              ctypes.addressof(cfg.ints), ctypes.addressof(cfg.doubles), B, nb,
              L, 0 if r is None else r.shape[0],
              0 if red is None else red.shape[0], int(control))
        upd = {}
        if ring_out is not None:
            upd.update(zip(RINGS, ring_out.unbind(0)))
            upd["equa_feas"], upd["ineq_feas"] = t_out[0], t_out[1]
        if not control:
            return upd, None, None
        tv, iv = t_out.unbind(0), i_out.unbind(0)
        upd.update(
            status=iv[0], rank_update=iv[1], update_cont=iv[2],
            ada_count=iv[3], iter=iv[4], target_rank=target_out, beta=tv[2],
            primal_step=tv[3], dual_step=tv[4], adapt_level=tv[5],
        )
        if not adaptive:
            return upd, None, None
        upd.update(avg_w=tv[6], last_restart_gap=tv[7], last_restart_iter=iv[5])
        return upd, iv[6], tv[8]  # stalled as K19's int32 flag

    # ------------------------------------------------------------- K20a
    def restart_average(self, s, o):
        """``restart_average_plain`` of the state's iterate and sums as
        one launch of K20a.  On the card the reductions come back as f64
        partials: (P, 5) for one instance (K19 folds them), (B, 5) for a
        batch."""
        p, m = self.cfg.p, self.cfg.m
        args = (s.x, s.y, s.Mx, s.Mty, s.avg_x, s.avg_y, s.avg_Mx, s.avg_Mty,
                s.avg_w, s.primal_step, o.c, o.b, o.h)
        x = s.x
        batched = x.dim() == 2
        name = "restart_average_batch" if batched else "restart_average"
        if x.device.type != "cuda" and _on_cpu(name, *args):
            return restart_average_plain(*args, p, m)
        key = (name, x.dtype, x.device, tuple(x.shape), s.y.shape[-1])
        plan = self._plans.get(key)
        if plan is None:
            _on_cpu(name, *args)
            plan = self._plans[key] = (
                _entry(name, x.dtype),
                *_check_restart_average(name, args, p, m, batched))
        return _restart_average_launch(*plan, args, p, m, batched)

    # ------------------------------------------------------------- K20b
    def restart_adopt(self, s, avgs, stalled, wsum):
        """``restart_adopt_plain`` as one launch of K20b, into fresh
        outputs (x and x_old alias after ``_residuals_and_gap``; the
        inputs stay as they are).  ``avgs``: K20a's four sums;
        ``stalled``: K19's int32 flag (bool on the CPU path too)."""
        args = (s.x, s.y, s.Mx, s.Mty, *avgs, stalled, wsum)
        x = s.x
        batched = x.dim() == 2
        name = "restart_adopt_batch" if batched else "restart_adopt"
        if x.device.type != "cuda" and _on_cpu(name, *args[:8], wsum):
            return restart_adopt_plain(*args[:8], stalled.bool(), wsum)
        key = (name, x.dtype, x.device, tuple(x.shape), s.y.shape[-1],
               stalled.dtype)
        plan = self._plans.get(key)
        if plan is None:
            _on_cpu(name, *args[:8], wsum)
            plan = self._plans[key] = (_entry(name, x.dtype),
                                       *_check_restart_adopt(name, args,
                                                             batched))
        return _restart_adopt_launch(*plan, args, batched)


def control_step(layout, opts, device) -> ControlStep:
    """The ControlStep of a runner of ``layout`` and ``opts`` on
    ``device``."""
    return ControlStep(control_config(layout, opts),
                       torch.tensor(layout.sdp_sides or (1,),
                                    dtype=torch.int32, device=device))


def control(s, o, cfg: ControlConfig, sides_arr, r=None, red=None,
            control: bool = True):
    """``ControlStep.control`` of a one-off step (its checks on every
    call)."""
    return ControlStep(cfg, sides_arr).control(s, o, r, red, control)


# -------------------------------------- K20 restart averaging (restart_avg.cu)


def restart_average_plain(x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty, avg_w,
                          ps, c, b, h, p: int, m: int):
    """K20a's plain twin (solver.py:809-860): the new running sums (+ ps
    times the iterate) and the reductions of the restart's test over
    their average, red = [c . x_bar, b . y_bar[:p], h . y_bar[p:], max
    |M x_bar[:p] - b|, max (M x_bar[p:] - h)] (0 where p or m is 0), in
    the program's dtype; a batch's (B, 5)."""
    avg_x = avg_x + _col(ps) * x
    avg_y = avg_y + _col(ps) * y
    avg_Mx = avg_Mx + _col(ps) * Mx
    avg_Mty = avg_Mty + _col(ps) * Mty
    wsum = torch.clamp_min(avg_w + ps, 1e-30)
    xa_ = avg_x / _col(wsum)
    ya_ = avg_y / _col(wsum)
    Mxa_ = avg_Mx / _col(wsum)
    zero = torch.zeros_like(wsum)
    red = torch.stack([
        _dot(c, xa_),
        _dot(b, ya_[..., :p]) if p else zero,
        _dot(h, ya_[..., p:]) if m else zero,
        torch.amax(torch.abs(Mxa_[..., :p] - b), -1) if p else zero,
        torch.amax(Mxa_[..., p:] - h, -1) if m else zero,
    ], dim=-1)
    return avg_x, avg_y, avg_Mx, avg_Mty, red


def restart_average(x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty, avg_w, ps,
                    c, b, h, p: int, m: int):
    """``restart_average_plain`` as one launch of K20a (a one-off
    ``ControlStep.restart_average``)."""
    batched = x.dim() == 2
    name = "restart_average_batch" if batched else "restart_average"
    args = (x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty, avg_w, ps, c, b, h)
    if _on_cpu(name, *args):
        return restart_average_plain(*args, p, m)
    return _restart_average_launch(
        _entry(name, x.dtype), *_check_restart_average(name, args, p, m,
                                                       batched),
        args, p, m, batched)


def _restart_average_launch(entry, B, n, pm, args, p, m, batched):
    x = args[0]
    bshape = (B,) if batched else ()
    ax = torch.empty((2,) + bshape + (n,), dtype=x.dtype, device=x.device)
    ay = torch.empty((2,) + bshape + (pm,), dtype=x.dtype, device=x.device)
    grid = B if batched else _reduce_grid(max(n, pm))
    partials = torch.empty((grid, RESTART_SLOTS), dtype=torch.float64,
                           device=x.device)
    keep = []
    _call(entry, x.device, *_data_ptrs(args, keep), ax.data_ptr(),
          ay.data_ptr(), partials.data_ptr(), B, n, p, m)
    return ax[0], ay[0], ay[1], ax[1], partials


def restart_adopt_plain(x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty,
                        stalled, wsum):
    """K20b's plain twin (solver.py:862-897): where ``stalled``, the
    average in place of the iterate, and the sums times keep = 0."""
    def mix(avg, cur):
        return torch.where(_col(stalled), avg, cur)

    xa = mix(avg_x / _col(wsum), x)
    ya = mix(avg_y / _col(wsum), y)
    Mxa = mix(avg_Mx / _col(wsum), Mx)
    Mtya = mix(avg_Mty / _col(wsum), Mty)
    keep = (~stalled).to(wsum.dtype)
    return (xa, ya, Mxa, Mtya, avg_x * _col(keep), avg_y * _col(keep),
            avg_Mx * _col(keep), avg_Mty * _col(keep))


def restart_adopt(x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty, stalled, wsum):
    """``restart_adopt_plain`` as one launch of K20b, into fresh outputs
    (a one-off ``ControlStep.restart_adopt``)."""
    batched = x.dim() == 2
    name = "restart_adopt_batch" if batched else "restart_adopt"
    args = (x, y, Mx, Mty, avg_x, avg_y, avg_Mx, avg_Mty, wsum)
    if _on_cpu(name, *args):
        return restart_adopt_plain(x, y, Mx, Mty, avg_x, avg_y, avg_Mx,
                                   avg_Mty, stalled.bool(), wsum)
    args = (*args[:8], stalled, wsum)
    return _restart_adopt_launch(_entry(name, x.dtype),
                                 *_check_restart_adopt(name, args, batched),
                                 args, batched)


def _restart_adopt_launch(entry, B, n, pm, args, batched):
    x, stalled, wsum = args[0], args[8], args[9]
    flag = stalled if stalled.dtype == torch.int32 else stalled.to(torch.int32)
    bshape = (B,) if batched else ()
    ox = torch.empty((4,) + bshape + (n,), dtype=x.dtype, device=x.device)
    oy = torch.empty((4,) + bshape + (pm,), dtype=x.dtype, device=x.device)
    keep = []
    _call(entry, x.device, *_data_ptrs((*args[:8], wsum, flag), keep),
          ox.data_ptr(), oy.data_ptr(), B, n, pm)
    return ox[0], oy[0], oy[1], ox[1], ox[2], oy[2], oy[3], ox[3]


# ---------------------------------------------- K21 freeze (freeze_rows.cu)

FREEZE_MAX_FIELDS = 96  # freeze_rows.cu: kMaxFields, the table of one launch


def freeze_rows_plain(mask, news: list, olds: list) -> list:
    """Per instance: new where ``mask`` (B,) holds, else old
    (parallel/batch.py:_where_rows, batch.py:149-155)."""
    def pick(n, o):
        return torch.where(mask.view((-1,) + (1,) * (n.dim() - 1)), n, o)

    return [pick(n, o) for n, o in zip(news, olds)]


def freeze_rows(mask, news: list, olds: list) -> list:
    """``freeze_rows_plain`` over every pair as one launch of K21 (more
    than FREEZE_MAX_FIELDS pairs take one launch a table of that many).
    Each pair shares a shape (B, ...) and a dtype; the outputs are fresh
    tensors.  One entry point serves every dtype (it copies 32-bit
    words)."""
    name = "freeze_rows"
    if len(news) != len(olds):
        raise ValueError(f"{name}: {len(news)} new and {len(olds)} old fields")
    if not news:
        return []
    if _on_cpu(name, *news, *olds, mixed=True, strided=True):
        if mask.device.type != "cpu":
            raise ValueError(f"{name}: mask on {mask.device}")
        return freeze_rows_plain(mask, news, olds)
    B = mask.shape[0]
    if mask.dim() != 1 or mask.device != news[0].device:
        raise ValueError(f"{name}: mask must be (B,) on the fields' device")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name}: mask must be bool")
    outs, table, keep = [], [], []
    for n, o in zip(news, olds):
        if n.shape != o.shape or n.dtype != o.dtype or n.shape[:1] != (B,):
            raise ValueError(f"{name}: a pair of shapes {tuple(n.shape)}, "
                             f"{tuple(o.shape)} or dtypes {n.dtype}, {o.dtype}")
        out = torch.empty_like(n, memory_format=torch.contiguous_format)
        outs.append(out)
        row_bytes = n[0].numel() * n.element_size() if B else 0
        if row_bytes % 4:
            raise ValueError(f"{name}: rows of {row_bytes} bytes (want a "
                             "multiple of 4)")
        if row_bytes:
            # any contiguous copy lives in ``keep`` until the launch is queued
            n, o = n.contiguous(), o.contiguous()
            keep += [n, o]
            table += [_ptr(n), _ptr(o), _ptr(out), row_bytes // 4]
    for lo in range(0, len(table), 4 * FREEZE_MAX_FIELDS):
        chunk = table[lo: lo + 4 * FREEZE_MAX_FIELDS]
        arr = (ctypes.c_int64 * len(chunk))(*chunk)
        _launch(name, "u32", news[0].device, _ptr(mask), ctypes.addressof(arr),
                len(chunk) // 4, B)
    return outs
