#!/usr/bin/env python3
"""Uninitialised reads on the card, found by filling freed memory with NaN.

    python3 tools/nan_memory_diagnostics.py

Needs a CUDA card.  PyTorch's caching allocator hands freed blocks back
as they were left; filling them with NaN before each step makes any
operation that reads memory it did not write show NaN.  Three parts:

1. ``eigh``: ``torch.linalg.eigh`` of an all-zero, a random and a
   low-rank symmetric matrix at sides 4-250 after the fill, raw and
   through ``ops.cones._eigh`` (raw, cuSOLVER leaves its outputs
   unwritten for the zero matrix: ROADMAP C27);
2. ``steps``: the f64 programs (dense eigh, packed and square; the
   subspace step, mixed and f64) stepped on the card and on the CPU from
   one state, the fill before every iteration; the first iteration and
   fields that part, or "equal";
3. ``solves``: whole solves on the card with the fill before every
   iteration, beside the CPU's.

    python3 tools/nan_memory_diagnostics.py --accept-always-hybrid

adds the default hybrid driver with ``subspace_accept_always=True`` on
the side-50 max-cut ``random_graph_weights(3, 50)``, on the card and on
the CPU (ROADMAP C28: ~32,000 iterations to status 2, ~10 minutes).

It prints readings and holds nothing.
"""

import sys

import numpy as np
import torch

sys.path.insert(0, ".")

import proxsdp_tpu_torch as tx  # noqa: E402
from proxsdp_tpu_torch import convert  # noqa: E402
from proxsdp_tpu_torch import solver as tsolver  # noqa: E402
from proxsdp_tpu_torch.models.maxcut import (  # noqa: E402
    maxcut_problem, random_graph_weights)
from proxsdp_tpu_torch.ops.cones import _eigh  # noqa: E402
from proxsdp_tpu_torch.ops.linop import build_linop  # noqa: E402
from proxsdp_tpu_torch.problem import preprocess, to_square_form  # noqa: E402


def fill_free_memory_with_nan():
    ts = [torch.full((nbytes // 8,), float("nan"), dtype=torch.float64,
                     device="cuda")
          for nbytes in [512 * 2 ** k for k in range(12)] * 20]
    ts.append(torch.full((2 ** 26,), float("nan"), dtype=torch.float64,
                         device="cuda"))
    del ts


def eigh_part():
    rng = np.random.default_rng(0)
    for side in (4, 16, 40, 100, 250):
        for kind in ("zero", "random", "lowrank"):
            if kind == "zero":
                A = torch.zeros(side, side, dtype=torch.float64, device="cuda")
            elif kind == "random":
                A = torch.tensor(rng.standard_normal((side, side)),
                                 device="cuda")
                A = 0.5 * (A + A.T)
            else:
                U = torch.tensor(rng.standard_normal((side, 3)), device="cuda")
                A = U @ U.T
            fill_free_memory_with_nan()
            w, V = torch.linalg.eigh(A)
            raw = bool(torch.isfinite(w).all() and torch.isfinite(V).all())
            fill_free_memory_with_nan()
            w, V = _eigh(A)
            fixed = bool(torch.isfinite(w).all() and torch.isfinite(V).all())
            print(f"eigh side {side} {kind}: torch.linalg.eigh finite {raw}, "
                  f"ops.cones._eigh finite {fixed}", flush=True)


def steps_part(side, square, kw, iters=80, seed=3):
    setup = preprocess(maxcut_problem(random_graph_weights(seed, side))[0])
    if square:
        setup = to_square_form(setup)
    layout = setup.layout
    opts = tx.Options(hybrid_precision=False, square_form=square, **kw)
    st, its = {}, {}
    for dev in ("cpu", "cuda"):
        o = convert.operands_from_numpy(
            M=build_linop(setup.A, setup.G, torch.float64, device=dev),
            b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
            norm_h=setup.norm_h, norm_c=setup.norm_c,
            obj_scale=setup.obj_scale * setup.rhs_scale, device=dev)
        its[dev] = (tsolver.make_chunk_runner(layout, opts, device=dev)[1], o)
        st[dev] = convert.state_from_numpy(
            tsolver.init_state(layout, opts, setup), dev)
    label = f"steps side {side} {'square' if square else 'packed'} {kw}"
    for k in range(iters):
        fill_free_memory_with_nan()
        for dev, (it, o) in its.items():
            st[dev] = it(st[dev], o, k)
        a = convert.state_to_numpy(st["cpu"])
        b = convert.state_to_numpy(st["cuda"])
        bad = []
        for f in tsolver.STATE_FIELDS:
            ga = np.asarray(a[f], np.float64) if f != "warm" else np.zeros(0)
            gb = np.asarray(b[f], np.float64) if f != "warm" else np.zeros(0)
            if ga.size == 0:
                continue
            fin = np.isfinite(ga)
            if not np.array_equal(np.isfinite(gb), fin):
                bad.append((f, "non-finite"))
            elif fin.any() and np.abs(ga[fin] - gb[fin]).max() > 1e-7 * max(
                    1.0, np.abs(ga[fin]).max()):
                bad.append((f, float(np.abs(ga[fin] - gb[fin]).max())))
        if bad:
            print(label, "iteration", k + 1, "parts:", bad[:6], flush=True)
            return
    print(label, f"{iters} iterations equal", flush=True)


def solves_part(extra=()):
    real = tsolver._primal_step

    def filled(*a, **kw):
        fill_free_memory_with_nan()
        return real(*a, **kw)

    tsolver._primal_step = filled
    try:
        for side, kw in ((50, {}), (50, {"square_form": False}),
                         (50, {"subspace_sign": True}),
                         (40, {"hybrid_precision": False,
                               "square_form": False}),
                         (250, {"hybrid_precision": False}), *extra):
            problem = maxcut_problem(random_graph_weights(3, side))[0]
            got = tx.solve(problem, tx.Options(**kw))
            want = tx.solve(problem, tx.Options(**kw), device="cpu")
            print(f"solve side {side} {kw}: card status {got.status} obj "
                  f"{got.objval!r} iter {got.iter}; CPU status {want.status} "
                  f"obj {want.objval!r} iter {want.iter}", flush=True)
    finally:
        tsolver._primal_step = real


def main() -> int:
    if not torch.cuda.is_available():
        print("nan_memory_diagnostics: needs a CUDA card", file=sys.stderr)
        return 2
    eigh_part()
    steps_part(40, False, {})
    steps_part(50, True, {})
    steps_part(40, True, {"subspace_rank": 8})
    steps_part(40, True, {"subspace_rank": 8, "subspace_mixed": False})
    steps_part(40, False, {"subspace_rank": 8, "subspace_accept_always": True,
                           "subspace_mixed": False})
    solves_part([(50, {"subspace_accept_always": True, "chunk_iters": 256})]
                if "--accept-always-hybrid" in sys.argv[1:] else [])
    return 0


if __name__ == "__main__":
    sys.exit(main())
