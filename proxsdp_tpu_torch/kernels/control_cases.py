"""Crafted states that drive every branch of the iteration's control (K19)
and of the restart (K20): ``chip_smoke.py``'s phase P holds the kernels to
their plain twins on them, and the CPU tests hold the plain twins to the
JAX package's ``_control`` on them.

``branch_cases(host, opts, c, b, h)`` takes a single instance's host
state (an ``init_state`` dict of any layout with equality rows and one
PSD block of side 3 or more) and the problem's c, b and h, and returns
``Case``s: a name, the options, the state and a check
that the control's output shows the branch fired.  Every case starts
from iteration 1000 with varied rings (so no stall test fires by
accident), then sets the slot the control reads and the counters its
branch needs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

ITER = 1000  # the iteration count before each crafted step
RINGS = ("buf_gap", "buf_prim_obj", "buf_dual_obj", "buf_feas", "buf_pres",
         "buf_dres", "buf_comb")
SLOT = {"gap": "buf_gap", "prim": "buf_prim_obj", "dual": "buf_dual_obj",
        "feas": "buf_feas", "pres": "buf_pres", "dres": "buf_dres",
        "comb": "buf_comb"}


class Case(NamedTuple):
    name: str
    opts: object
    state: dict
    fired: Callable[[dict, dict], bool]  # (input, output) -> the branch fired


def _copy(host: dict) -> dict:
    return {k: (tuple(np.array(w) for w in v) if k == "warm" else np.array(v))
            for k, v in host.items()}


def branch_cases(host: dict, opts, c, b, h, seed: int = 0) -> list:
    """The crafted cases (see the module docstring) from ``host`` under
    ``opts`` (its dtype is the state's); ``c``, ``b``, ``h`` the
    operands'."""
    rng = np.random.default_rng(seed)
    dt = host["buf_gap"].dtype
    L = host["buf_gap"].shape[0]
    w = opts.convergence_window
    k = ITER + 1
    idx = ITER % L
    back = (k - w - 1) % L

    def f(v):
        return np.asarray(v, dt)

    def i32(v):
        return np.int32(v)

    def state(slot=None, comb_back=1.0, constant_ring=None, **fields):
        """``slot``: the values the control reads this iteration;
        ``comb_back``: the combined residual a window back (below the
        current one: divergence); ``constant_ring``: (ring, value), a ring
        that stalled; ``fields``: state fields set outright."""
        st = _copy(host)
        for name in RINGS:
            st[name] = f(0.3 + 0.2 * rng.random(L))
        if constant_ring is not None:
            st[constant_ring[0]] = np.full(L, constant_ring[1], dt)
        vals = dict(gap=0.5, feas=0.01, pres=0.01, dres=0.01, comb=0.02,
                    prim=1.0, dual=0.9)
        vals.update(slot or {})
        for key, v in vals.items():
            st[SLOT[key]][idx] = v
        st["buf_comb"][back] = comb_back
        st.update(iter=i32(ITER), status=i32(0), rank_update=i32(5),
                  update_cont=i32(0), ada_count=i32(0), cert_kind=i32(0),
                  cert_wait_until=i32(0), infeas_block_until=i32(0),
                  opt_block_until=i32(0), last_restart_iter=i32(ITER),
                  last_restart_gap=f(np.inf), adapt_level=f(0.5),
                  beta=f(1.5), primal_step=f(0.25), dual_step=f(0.2),
                  avg_w=f(2.0), max_soc_gap=f(-np.inf))
        st["min_eig"] = np.full_like(host["min_eig"], -0.1)
        st["target_rank"] = np.full_like(host["target_rank"], 2)
        st["current_rank"] = np.full_like(host["current_rank"], 2)
        if st["avg_x"].size:
            for name in ("avg_x", "avg_y", "avg_Mx", "avg_Mty"):
                st[name] = f(rng.standard_normal(st[name].shape))
        for name, v in fields.items():
            st[name] = np.asarray(v, st[name].dtype)
        return st

    def status_is(want):
        return lambda i, o: int(o["status"]) == want

    cases = [
        Case("status 1", opts, state(dict(gap=1e-6, feas=1e-6)), status_is(1)),
        Case("opt_block_until", opts,
             state(dict(gap=1e-6, feas=1e-6), opt_block_until=k + 5),
             status_is(0)),
        Case("b1 (bump, reset)", opts.replace(min_size_krylov_eigs=2),
             state(dict(gap=1e-6, feas=1e-6), rank_update=w + 5,
                   min_eig=np.full_like(host["min_eig"], 0.5)),
             lambda i, o: (int(o["rank_update"]) == 0
                           and int(o["update_cont"]) == 0
                           and (o["target_rank"] > i["target_rank"]).all())),
        Case("b2 with reset", opts,
             state(comb_back=0.001, rank_update=w + 5,
                   update_cont=opts.divergence_min_update),
             lambda i, o: (int(o["rank_update"]) == 0
                           and int(o["update_cont"]) == 0)),
        Case("b2 without reset", opts,
             state(comb_back=0.001, rank_update=w + 5, update_cont=3),
             lambda i, o: (int(o["update_cont"]) == 4
                           and int(o["rank_update"]) == w + 6)),
    ]
    for ls in (True, False):
        for balance in ("ratio", "reference"):
            o2 = opts.replace(line_search_flag=ls, step_balance=balance)
            hi, lo = (0.5, 0.01) if balance == "ratio" else (1e-2, 1e-6)
            for fire, slot in (("fire3", dict(pres=hi, dres=lo)),
                               ("fire4", dict(pres=lo, dres=hi))):
                cases.append(Case(
                    f"{fire} line_search_flag={ls} step_balance={balance}", o2,
                    state(slot, ada_count=opts.adapt_window),
                    _fired_step(fire, ls)))
    cases += [
        Case("status 6 (dual objective > max_obj)", opts,
             state(dict(dual=1e21)), status_is(6)),
        Case("status 6 (NaN dual objective)", opts,
             state(dict(dual=np.nan)), status_is(6)),
        Case("status 5 (primal objective < -max_obj)", opts,
             state(dict(prim=-1e21)), status_is(5)),
        Case("status 6 (stalled feasibility)", opts,
             state(constant_ring=("buf_feas", 0.01)), status_is(6)),
        Case("infeas_block_until", opts,
             state(constant_ring=("buf_feas", 0.01),
                   infeas_block_until=k + 5), status_is(0)),
        Case("status 6 (stalled gap, |dual| > |prim|)", opts,
             state(dict(gap=0.99995, prim=1.0, dual=2.0),
                   constant_ring=("buf_gap", 0.99995)), status_is(6)),
        Case("status 5 (stalled gap, |prim| > |dual|)", opts,
             state(dict(gap=0.99995, prim=2.0, dual=1.0, feas=1e-5),
                   constant_ring=("buf_gap", 0.99995)), status_is(5)),
        Case("status 7 (primal ray)", opts,
             state(dict(prim=-10.0, feas=1e-4), cert_kind=5,
                   cert_wait_until=k + 100), status_is(7)),
        Case("certificate wait", opts,
             state(dict(gap=1e-6, feas=1e-6), cert_kind=6,
                   cert_wait_until=k + 10),
             lambda i, o: (int(o["status"]) == 0
                           and int(o["rank_update"]) == int(i["rank_update"])
                           and int(o["iter"]) == k)),
    ]
    if opts.restart == "adaptive":
        cases += [_epoch_case(state, opts, f, k, c, b, h, stalled=True),
                  _epoch_case(state, opts, f, k, c, b, h, stalled=False)]
    return cases


def _fired_step(fire: str, ls: bool):
    """fire3 lengthens the primal step and shortens the dual one (beta
    under the linesearch), fire4 the reverse; either resets ada_count and
    decays adapt_level."""
    def fired(i, o):
        up = fire == "fire3"
        ps = float(o["primal_step"]) > float(i["primal_step"])
        other = (float(o["beta"]) < float(i["beta"]) if ls
                 else float(o["dual_step"]) < float(i["dual_step"]))
        return (int(o["ada_count"]) == 0
                and float(o["adapt_level"]) < float(i["adapt_level"])
                and ps == up and other == up)
    return fired


def _epoch_case(state, opts, f, k, c, b, h, stalled: bool):
    """A restart epoch (k - last_restart_iter >= restart_window) whose gap
    did not shrink: the average is adopted when it beats the iterate
    (stalled: zero objectives, M x_bar[:p] = b), else kept (an average
    objective ~1e6)."""
    st = state(dict(gap=0.05), last_restart_iter=0, last_restart_gap=0.01,
               avg_w=3.0)
    ps = float(st["primal_step"])
    wsum = float(st["avg_w"]) + ps
    Mx = np.concatenate([np.asarray(b, np.float64),
                         np.asarray(h, np.float64) - 1.0])
    st["Mx"] = f(Mx)
    st["avg_Mx"] = f(Mx * (wsum - ps))
    for name in ("x", "y", "avg_y"):
        st[name] = f(np.zeros_like(st[name]))
    st["avg_x"] = f(np.zeros_like(st["avg_x"]))
    if not stalled:  # the average's objective huge: gap_a ~ 1
        st["avg_x"] = f(1e6 * np.sign(np.asarray(c, np.float64)))
    if stalled:
        return Case("restart epoch, stalled", opts, st,
                    lambda i, o: float(o["avg_w"]) == 0.0
                    and int(o["last_restart_iter"]) == k)
    return Case("restart epoch, not stalled", opts, st,
                lambda i, o: float(o["avg_w"]) > 0.0
                and int(o["last_restart_iter"]) == k)
