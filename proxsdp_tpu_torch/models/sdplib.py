"""SDPLIB / SDPA sparse format (.dat-s) reader and model builder; a copy
of ``proxsdp_tpu/models/sdplib.py``.

Behavioral port of test/base_sdplib.jl + test/moi_sdplib.jl: all blocks are
embedded into ONE big PSD block of side sum(|block sizes|) (the reference
does the same), and the model solved is

    min  <F0, X>   s.t.  <Fk, X> = c_k  (k = 1..m),   X psd,

with F0 already negated during parsing (base_sdplib.jl:36), so SDPLIB's
published optima appear with flipped sign (e.g. mcp124-1: published 141.990,
objective here -141.990).

Uses the fast C++ parser (``utils/native.py``, built at first use) when
it builds, else pure Python.
"""

from __future__ import annotations

import os

import numpy as np

from ..api import Optimizer
from ..options import Options
from ..utils.vech import sympackedlen, tri_pos


def _parse_block_line(line: str):
    toks = line.replace("{", " ").replace("}", " ").replace("(", " ") \
        .replace(")", " ").replace(",", " ").split()
    return [int(float(t)) for t in toks]


def sdplib_data(path: str):
    """Parse a .dat-s file -> (n, m, entries, c).

    entries: (nnz, 4) float array of rows [matno, i, j, val] with 1-based
    i<=j indices already offset into the big embedded matrix and F0
    negated; matno 0 = objective.
    """
    native = _try_native(path)
    if native is not None:
        return native
    return _parse_python(path)


def _parse_python(path: str):
    """The pure-Python parser behind ``sdplib_data``."""
    with open(path) as f:
        lines = f.readlines()
    # strip comments
    body = [ln for ln in lines if ln.strip() and ln.lstrip()[0] not in "*\"'"]
    m = int(float(body[0].split()[0]))
    nblocks = int(float(body[1].split()[0]))
    blks = _parse_block_line(body[2])[:nblocks]
    c = np.asarray(
        [float(t) for t in body[3].replace("{", " ").replace("}", " ")
         .replace(",", " ").split()][:m]
    )
    cum = np.concatenate([[0], np.cumsum(np.abs(blks))])
    n = int(cum[-1])

    recs = []
    for ln in body[4:]:
        t = ln.split()
        if len(t) < 5:
            continue
        matno, blk, i, j, val = (
            int(float(t[0])), int(float(t[1])), int(float(t[2])),
            int(float(t[3])), float(t[4]),
        )
        off = cum[blk - 1]
        i, j = i + off, j + off
        if i > j:
            i, j = j, i
        if matno == 0:
            val = -val  # reference negates the objective block
        recs.append((matno, i, j, val))
    entries = np.asarray(recs, dtype=np.float64) if recs else np.zeros((0, 4))
    return n, m, entries, c


def _try_native(path: str):
    """The C++ parser (utils/native.py, built at first use), or None where
    it does not build or fails."""
    try:
        from ..utils.native import parse_sdpa
    except Exception:
        return None
    try:
        return parse_sdpa(path)
    except Exception:
        return None


def sdplib_blocks(path: str):
    """Block-structure line of a .dat-s file: list of signed block sizes
    (negative = diagonal/LP block, SDPA convention)."""
    with open(path) as f:
        body = []
        for ln in f:
            if ln.strip() and ln.lstrip()[0] not in "*\"'":
                body.append(ln)
                if len(body) >= 3:
                    break
    nblocks = int(float(body[1].split()[0]))
    return _parse_block_line(body[2])[:nblocks]


def sdplib_problem(
    path: str, options: Options | None = None, *, split_blocks: bool = True
):
    """Build the ConicProblem for a .dat-s instance; returns (problem, X).

    split_blocks=True (default; TPU-first deviation from the reference):
    each SDPA block becomes its own PSD block, and diagonal (negative-
    size) blocks become nonnegative scalar variables (one inequality row
    each) instead of being embedded in one huge dense PSD block.  The
    reference's base_sdplib.jl embeds everything into a single block of
    side sum(|sizes|), which turns e.g. arch0 (161-dense + 174-diagonal)
    into a side-335 dense block and makes the LP part pay an O(side^3)
    eigendecomposition; split mode solves the same problem with a side-161
    eigh + 174 scalar projections.  split_blocks=False reproduces the
    reference embedding exactly.

    X is the index matrix of the largest PSD block (for solution
    extraction / PSD-ness checks).
    """
    n, m, entries, c = sdplib_data(path)

    opt = Optimizer(options)
    if not split_blocks:
        tl = sympackedlen(n)

        def tvar(i, j):
            return int(tri_pos(i - 1, j - 1))

        obj: dict = {}
        rows: list[dict] = [dict() for _ in range(m)]
        for matno, i, j, val in entries:
            matno, i, j = int(matno), int(i), int(j)
            coef = val if i == j else 2.0 * val
            tgt = obj if matno == 0 else rows[matno - 1]
            v = tvar(i, j)
            tgt[v] = tgt.get(v, 0.0) + coef
        X = opt.add_psd_var(n)
        for k in range(m):
            opt.add_eq_constraint(rows[k], c[k])
        opt.set_objective(obj, sense="min")
        return opt.build_problem(), X

    blks = sdplib_blocks(path)
    cum = np.concatenate([[0], np.cumsum(np.abs(blks))])

    psd_idx = {}
    diag_vars = {}
    for bi, bs in enumerate(blks):
        if bs > 0:
            psd_idx[bi] = opt.add_psd_var(int(bs))
        else:
            d = -int(bs)
            vs = opt.add_free_vars(d)
            diag_vars[bi] = vs
            for v in vs:
                opt.add_ineq_constraint({int(v): -1.0}, 0.0)  # v >= 0

    obj = {}
    rows = [dict() for _ in range(m)]
    for matno, i, j, val in entries:
        matno, i, j = int(matno), int(i), int(j)
        bi = int(np.searchsorted(cum, i - 1, side="right")) - 1
        li, lj = i - int(cum[bi]), j - int(cum[bi])
        if bi in psd_idx:
            v = int(psd_idx[bi][li - 1, lj - 1])
            coef = val if li == lj else 2.0 * val
        else:
            assert li == lj, "off-diagonal entry in a diagonal block"
            v = int(diag_vars[bi][li - 1])
            coef = val
        tgt = obj if matno == 0 else rows[matno - 1]
        tgt[v] = tgt.get(v, 0.0) + coef

    for k in range(m):
        opt.add_eq_constraint(rows[k], c[k])
    opt.set_objective(obj, sense="min")
    X = None
    if psd_idx:
        big = max(psd_idx, key=lambda b: blks[b])
        X = psd_idx[big]
    return opt.build_problem(), X


def solve_sdplib(path: str, options: Options | None = None, *,
                 device="cuda", **kwargs):
    from ..solver import solve

    problem, Xidx = sdplib_problem(path, options)
    if kwargs:
        options = (options or Options()).replace(**kwargs)
    res = solve(problem, options, device=device)
    return res.primal[Xidx], res


def sdplib_eval(path: str, X: np.ndarray):
    """PSD-ness check as in moi_sdplib.jl:53-56: count eigs < -1e-4."""
    eigs = np.linalg.eigvalsh(X)
    return int(np.sum(eigs < -1e-4))
