"""The port's batch driver over any cone layout against the JAX package's.

``proxsdp_tpu_torch.parallel.batch.solve_batch`` on a sweep of one conic
program with several PSD blocks (one group of same-side blocks and a
single), SOC blocks and LP coordinates, every instance with its own b and
c: the f64 program stepped from one stacked init_state under the ELL or
dense, the COO and per-instance dense operators; whole solves in f64 and
under the default hybrid Options(); batches of pure LPs and pure SOCPs
from the conformance battery; the subspace mode on two subspace blocks
beside a grouped pair; a shared operator that ``build_linop`` makes COO
under ``linop="auto"``; an infeasible instance's re-entry into ``solve``;
and the batched SOC and COO kernels' plain versions against the
single-instance ones.  chip_smoke.py's phase M runs the same sweep at
phase I's size on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.parallel import batch as jbatch
from proxsdp_tpu.problem import preprocess as jpreprocess
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.ops.linop import CooOp, DenseOp, EllOp, build_linop
from proxsdp_tpu_torch.parallel import batch as tbatch
from proxsdp_tpu_torch.problem import preprocess
from test_torch_batch_subspace import _jax_logged

B = 4
SIDES, SOC_LENS, N_LP, ROWS, DENSITY = (4, 4, 9), (3, 5, 5), 6, 20, 0.3


# ---------------------------------------------------------------------------
# chip_smoke.py's generator (conic_indices, conic_program_data,
# conic_sweep_instance, build_conic_program), copied
# ---------------------------------------------------------------------------


def conic_indices(sides, soc_lens, n_lp: int):
    diags, pos = [], 0
    for side in sides:
        j = np.repeat(np.arange(side), np.arange(1, side + 1))
        i = np.concatenate([np.arange(k + 1) for k in range(side)])
        diags.append(pos + np.nonzero(i == j)[0])
        pos += side * (side + 1) // 2
    soc_off = pos + np.concatenate([[0], np.cumsum(soc_lens)[:-1]])
    pos += sum(soc_lens)
    return diags, soc_off.astype(int), np.arange(pos, pos + n_lp), pos + n_lp


def conic_program_data(seed=0, sides=SIDES, soc_lens=SOC_LENS, n_lp=N_LP,
                       rows=ROWS, density=DENSITY) -> dict:
    rng = np.random.default_rng(seed)
    diags, soc_off, lp, N = conic_indices(sides, soc_lens, n_lp)
    anchors = diags + [np.array([off]) for off in soc_off] + [lp]
    x0 = np.zeros(N)
    s0 = np.zeros(N)
    for d in diags:
        x0[d] = 1.0
        s0[d] = 1.0
    for off, ln in zip(soc_off, soc_lens):
        x0[off] = 1.0
        v = rng.standard_normal(ln - 1)
        s0[off] = 1.5
        s0[off + 1 : off + ln] = 0.5 * v / np.linalg.norm(v)
    x0[lp] = 1.0
    k = int(round(density * N))
    cols = anchors + [np.sort(rng.choice(N, size=k, replace=False))
                      for _ in range(rows - len(anchors))]
    vals = [rng.standard_normal(len(cl)) for cl in cols]
    vals = [v / np.linalg.norm(v) for v in vals]
    b = np.array([np.dot(v, x0[cl]) for cl, v in zip(cols, vals)])
    y0 = rng.standard_normal(rows)
    z0 = 1.0 + rng.random(n_lp)
    aty = np.zeros(N)
    for cl, v, y in zip(cols, vals, y0):
        aty[cl] += v * y
    c = s0 - aty
    c[lp] += z0
    return {"sides": tuple(sides), "soc_lens": tuple(soc_lens), "n_lp": n_lp,
            "cols": cols, "vals": vals, "b": b, "c": c}


def conic_sweep_instance(data: dict, s: int) -> dict:
    rng = np.random.default_rng(s)
    sides, soc_lens, n_lp = data["sides"], data["soc_lens"], data["n_lp"]
    cols, vals = data["cols"], data["vals"]
    diags, soc_off, lp, N = conic_indices(sides, soc_lens, n_lp)
    x0, s0 = np.zeros(N), np.zeros(N)
    for d in diags:
        x0[d] = 1.0 + rng.random(d.size)
        s0[d] = 1.0 + rng.random(d.size)
    for off, ln in zip(soc_off, soc_lens):
        w, v = rng.standard_normal(ln - 1), rng.standard_normal(ln - 1)
        x0[off] = 2.0 + rng.random()
        x0[off + 1 : off + ln] = rng.random() * w / np.linalg.norm(w)
        s0[off] = 1.5
        s0[off + 1 : off + ln] = 0.5 * v / np.linalg.norm(v)
    x0[lp] = 1.0 + rng.random(n_lp)
    y0 = rng.standard_normal(len(cols))
    z0 = 1.0 + rng.random(n_lp)
    aty = np.zeros(N)
    for cl, v, y in zip(cols, vals, y0):
        aty[cl] += v * y
    c = s0 - aty
    c[lp] += z0
    b = np.array([np.dot(v, x0[cl]) for cl, v in zip(cols, vals)])
    return {**data, "b": b, "c": c}


def build_conic_program(pkg, data: dict):
    opt = pkg.Optimizer()
    Xs = [opt.add_psd_var(side) for side in data["sides"]]
    socs = [opt.add_soc_var(ln) for ln in data["soc_lens"]]
    lp = opt.add_free_vars(data["n_lp"])
    for cols, vals, rhs in zip(data["cols"], data["vals"], data["b"]):
        opt.add_eq_constraint(dict(zip(cols.tolist(), vals.tolist())), rhs)
    for v in lp:
        opt.add_ineq_constraint({int(v): -1.0}, 0.0)
    opt.set_objective({v: float(cv) for v, cv in enumerate(data["c"])
                       if cv != 0.0})
    return opt.build_problem(), Xs, socs, lp


# ---------------------------------------------------------------------------


def _sweep(pkg, B=B, per_instance=False, **kw):
    """B instances of the sweep: one operator (conic_program_data(0)), or
    each instance's own (conic_program_data(s)), b and c by instance."""
    return [build_conic_program(pkg, conic_sweep_instance(
        conic_program_data(seed=s if per_instance else 0, **kw), s))[0]
        for s in range(B)]


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def _compare_states(got, want, B):
    np.testing.assert_array_equal(got["iter"], np.full(B, want["iter"][0]))
    for name in want:
        if name == "warm":  # eigenvectors: compared up to sign
            for g, w in zip(got[name], want[name], strict=True):
                np.testing.assert_allclose(np.abs(np.sum(g * w, axis=1)), 1.0,
                                           rtol=0, atol=1e-9)
            continue
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12,
                                       err_msg=name)


# the operator each case gives the port and the JAX driver, the port's
# operator type and both drivers' kinds
OPERATOR_CASES = {
    "auto": ("auto", None, EllOp, "shared"),
    "coo": ("coo", "coo", CooOp, "shared"),
    "per_instance_dense": ("dense", None, DenseOp, "dense_batched"),
}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_iterates_match_jax(case):
    """60 iterations of the f64 program from one stacked init_state over
    three PSD blocks (a group of two side-4 blocks, a side-9 single), three
    SOC blocks and six LP coordinates: every field within 1e-10 relative,
    iterations and statuses equal, under the port's ELL operator (JAX:
    dense), the COO operator in both, and per-instance dense operators."""
    linop, jforce, ttype, kind = OPERATOR_CASES[case]
    per = case == "per_instance_dense"
    opts_j = jbatch._force_batch_options(jx.Options(hybrid_precision=False))
    opts_t = tbatch._force_batch_options(tx.Options(hybrid_precision=False))
    setups_j = [jpreprocess(p) for p in _sweep(jx, per_instance=per)]
    layout = setups_j[0].layout
    assert len(layout.sdp_sides) == 3 and len(layout.soc_lens) == 3
    ops_j, kind_j = jbatch._batch_operands(setups_j, jnp.float64, jforce)
    assert kind_j == kind
    states_j = jbatch._stack_states(
        [jbatch.init_state(layout, opts_j, s) for s in setups_j])
    host = tp.jax_state_numpy(states_j)
    run_j, _ = jbatch._cached_batch_runner(layout, opts_j, kind)
    want = tp.jax_state_numpy(run_j(
        states_j, ops_j._replace(chunk_end=jnp.asarray(60, jnp.int32))))

    setups_t = [preprocess(p) for p in _sweep(tx, per_instance=per)]
    ops_t = tbatch._batch_operands(setups_t, torch.float64, tp.DEV, linop)
    assert tbatch.operator_kind(ops_t.M) == kind
    assert isinstance(ops_t.M, ttype)
    run_t = tbatch.make_batch_runner(setups_t[0].layout, opts_t,
                                     device=tp.DEV)[0]
    got = convert.state_to_numpy(run_t(convert.state_from_numpy(host, tp.DEV),
                                       ops_t, 60))
    assert want["iter"].tolist() == [60] * B
    _compare_states(got, want, B)


@pytest.fixture(scope="module")
def f64_results():
    opts = dict(hybrid_precision=False, tol_gap=1e-4, tol_feasibility=1e-4)
    return (jbatch.solve_batch(_sweep(jx), jx.Options(**opts)),
            tx.solve_batch(_sweep(tx), tx.Options(**opts), device="cpu"))


def test_f64_solve_matches_jax(f64_results):
    """The f64 program to convergence: status 1 everywhere, the same
    iterations, objectives within 1e-9 and the primal within 1e-8."""
    want, got = f64_results
    for g, w in zip(got, want, strict=True):
        assert g.status == w.status == 1
        assert g.iter == w.iter
        assert _rel(g.objval, w.objval) <= 1e-9
        np.testing.assert_allclose(g.primal, w.primal, rtol=0, atol=1e-8)


def test_hybrid_solve_matches_jax():
    """Default Options(): the f32 race (K9 on the group and the single,
    K13b, the batched products), the hand-over and the f64 phase.
    Statuses equal, objectives within 1e-4 (1 + |obj|), iterations within
    25 % (f32 rounding moves the race's stall decisions, ROADMAP C9)."""
    want = jbatch.solve_batch(_sweep(jx), jx.Options())
    stats = tbatch.BatchStats()
    got = tx.solve_batch(_sweep(tx), tx.Options(), device="cpu", stats=stats)
    assert 0 < stats.race_iters <= max(r.iter for r in got)
    for g, w in zip(got, want, strict=True):
        assert g.status == w.status == 1
        assert _rel(g.objval, w.objval) <= 1e-4
        assert abs(g.iter - w.iter) <= 0.25 * w.iter


def _lp_sweep(pkg, s):
    # test_conformance.py::TestLP::test_max_two_vars with the first row's
    # right-hand side 3 + s / 2: optimum x = 1, y = (2 + s / 2) / 2
    o = pkg.Optimizer()
    x, y = (int(v) for v in o.add_free_vars(2))
    o.add_ineq_constraint({x: 1.0, y: 2.0}, 3.0 + 0.5 * s)
    o.add_ineq_constraint({x: 1.0}, 1.0)
    o.add_ineq_constraint({x: -1.0}, 0.0)
    o.add_ineq_constraint({y: -1.0}, 0.0)
    o.set_objective({x: 1.0, y: 1.0}, sense="max")
    return o.build_problem(), 1.0 + (2.0 + 0.5 * s) / 2.0


def _socp_sweep(pkg, s):
    # test_conformance.py::TestSOC::test_two_blocks with ||3 + s|| <= t1:
    # optimum 7 + s
    o = pkg.Optimizer()
    s1 = o.add_soc_var(2)
    s2 = o.add_soc_var(2)
    o.add_eq_constraint({int(s1[1]): 1.0}, 3.0 + s)
    o.add_eq_constraint({int(s2[1]): 1.0}, 4.0)
    o.set_objective({int(s1[0]): 1.0, int(s2[0]): 1.0})
    return o.build_problem(), 7.0 + s


@pytest.mark.parametrize("build", [_lp_sweep, _socp_sweep],
                         ids=["lp", "socp"])
def test_layouts_without_psd_blocks(build):
    """Batches without a PSD block (pure LPs; pure SOCPs on K13b): status
    1, the known optimum within 1e-3 (1 + |obj|), the JAX batch's
    statuses, iterations and objectives (1e-9) under the f64 program."""
    opts = dict(hybrid_precision=False, tol_gap=1e-4, tol_feasibility=1e-4)
    want = jbatch.solve_batch([build(jx, s)[0] for s in range(3)],
                              jx.Options(**opts))
    got = tx.solve_batch([build(tx, s)[0] for s in range(3)],
                         tx.Options(**opts), device="cpu")
    for s, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.status == w.status == 1
        assert g.iter == w.iter
        assert _rel(g.objval, w.objval) <= 1e-9
        assert _rel(g.objval, build(tx, s)[1]) <= 1e-3


SUB_SIDES, SUB_B = (40, 4, 40, 4), 40


def test_subspace_mode_matches_jax(monkeypatch):
    """The subspace mode ("auto" at B = 40) on two side-40 blocks (the
    subspace step, K12) beside a grouped pair of side-4 blocks (K9 in the
    same step), an SOC block and LP coordinates, in the f64 program: the
    JAX driver's reseeds (k, instances masked, r_max) and programs, its
    statuses and iterations, objectives within 1e-6 (1 + |obj|), the
    JAX run lined up on every subspace block (``_jax_logged``).  The
    reseed at iteration 128 sees rank 17 on a block, so the batch drops
    to the eigh program on every block; the run stops at 300 iterations
    (most instances at status 3 in both drivers)."""
    kw = dict(sides=SUB_SIDES, soc_lens=(3,), n_lp=2, rows=12, density=0.2)
    opts = dict(hybrid_precision=False, subspace_mixed=False, tol_gap=1e-4,
                tol_feasibility=1e-4, max_iter=300)
    events = {"reseeds": [], "programs": [], "patched": False}
    _jax_logged(monkeypatch, events)
    want = jbatch.solve_batch(_sweep(jx, SUB_B, **kw), jx.Options(**opts))
    stats = tbatch.BatchStats()
    got = tx.solve_batch(_sweep(tx, SUB_B, **kw), tx.Options(**opts),
                         device="cpu", stats=stats)
    assert events["patched"] and events["reseeds"]
    assert [(k, n, r) for _, _, _, k, n, r in stats.reseeds] == \
        events["reseeds"]
    assert [(d, k) for d, _, k in stats.programs] == events["programs"]
    assert events["programs"] == [("float64", 16), ("float64", 0)]
    for g, w in zip(got, want, strict=True):
        assert g.status == w.status and g.status in (1, 3)
        assert g.iter == w.iter
        assert _rel(g.objval, w.objval) <= 1e-6


def test_shared_coo_operator_under_auto(monkeypatch):
    """ROADMAP C26: a shared operator that ``build_linop`` makes COO under
    ``linop="auto"`` (rows of ~38 entries, too wide for ELL, on a matrix
    above the dense limit, here 0) runs the batch on K14b and K15b's COO
    form: the JAX batch's statuses, iterations and objectives (1e-9) in
    f64."""
    kw = dict(density=0.45)
    monkeypatch.setattr(tbatch, "build_linop",
                        functools.partial(build_linop, dense_limit=0))
    setups = [preprocess(p) for p in _sweep(tx, **kw)]
    ops = tbatch._batch_operands(setups, torch.float64, tp.DEV, "auto")
    assert isinstance(ops.M, CooOp) and tbatch.operator_kind(ops.M) == "shared"
    opts = dict(hybrid_precision=False, tol_gap=1e-4, tol_feasibility=1e-4)
    want = jbatch.solve_batch(_sweep(jx, **kw), jx.Options(**opts))
    got = tx.solve_batch(_sweep(tx, **kw), tx.Options(**opts), device="cpu")
    for g, w in zip(got, want, strict=True):
        assert g.status == w.status == 1
        assert g.iter == w.iter
        assert _rel(g.objval, w.objval) <= 1e-9


class _FrozenClock:
    """A clock that never moves (tests/test_torch_certificates.py): both
    drivers take their best-iterate snapshots at the same iterations."""

    @staticmethod
    def time():
        return 0.0


def _cert_program(pkg, bad: bool):
    """Two PSD blocks, an SOC block and an LP coordinate; ``bad`` asks
    X_00 = -1 of the PSD block X (infeasible: a dual ray exists)."""
    o = pkg.Optimizer()
    X = o.add_psd_var(2)
    Y = o.add_psd_var(3)
    s = o.add_soc_var(3)
    (z,) = o.add_free_vars(1)
    o.add_eq_constraint({int(X[0, 0]): 1.0}, -1.0 if bad else 1.0)
    o.add_eq_constraint({int(Y[i, i]): 1.0 for i in range(3)}, 3.0)
    o.add_eq_constraint({int(s[1]): 1.0}, 3.0)
    o.add_eq_constraint({int(z): 1.0}, 2.0)
    o.add_ineq_constraint({int(z): -1.0}, 0.0)
    o.set_objective({int(X[1, 1]): 1.0, int(Y[0, 1]): 1.0, int(s[0]): 1.0,
                     int(z): 1.0})
    return o.build_problem()


def test_certificate_reentry_multiblock(monkeypatch):
    """One infeasible instance in a multi-block batch: the others reach
    status 1, it is declared and re-enters ``solve`` from its packed batch
    iterate (every PSD block mapped to the square form, the SOC block and
    the tail carried), which finds the dual ray: status 6, as the JAX
    driver's, with the same flag and string."""
    for mod in (jsolver, tsolver, jbatch, tbatch):
        monkeypatch.setattr(mod, "time", _FrozenClock)
    kw = dict(hybrid_precision=False, max_iter=20_000, chunk_iters=256)
    flags = (False, True, False)
    want = jbatch.solve_batch([_cert_program(jx, f) for f in flags],
                              jx.Options(**kw))
    got = tbatch.solve_batch([_cert_program(tx, f) for f in flags],
                             tx.Options(**kw), device="cpu")
    for g, w in zip(got, want, strict=True):
        assert g.status == w.status, (g.status_string, w.status_string)
        assert g.certificate_found == w.certificate_found
        assert g.status_string == w.status_string
    assert [r.status for r in got] == [1, 6, 1]
    assert got[1].certificate_found


def test_batched_soc_plain_matches_rows():
    """soc_projection_batch_plain equals soc_projection_plain applied row
    by row, bit for bit: blocks of lengths 1-60 in all three cases (inside
    the cone, in its polar, outside both) and with v = 0."""
    rng = np.random.default_rng(3)
    lens = tuple(1 + (13 * i) % 60 for i in range(40))
    V = rng.standard_normal((7, sum(lens)))
    off = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for i, (o, ln) in enumerate(zip(off, lens)):
        nv = np.linalg.norm(V[:, o + 1 : o + ln], axis=1)
        V[:, o] = (2.0 * nv, -1.5 * nv, 0.3 * nv, -0.7)[i % 4]
        if i % 4 == 3:
            V[:, o + 1 : o + ln] = 0.0
    V = torch.tensor(V)
    out, gap = kernels.soc_projection_batch(V, lens)
    assert out.shape == V.shape and gap.shape == (7,)
    for i in range(7):
        o, g = kernels.soc_projection_plain(V[i].clone(), lens)
        assert torch.equal(out[i], o) and torch.equal(gap[i], g)


def test_batched_coo_plain_matches_rows():
    """coo_spmv_batch_plain equals coo_spmv_plain on each row, bit for
    bit, over both segment tables of a CooOp (M x and M' y), and the
    CooOp's batched products are those."""
    rng = np.random.default_rng(4)
    setup = preprocess(_sweep(tx, 1, density=0.45)[0])
    M = build_linop(setup.A, setup.G, torch.float64, device="cpu",
                    force="coo")
    nr, nc = M.shape
    X = torch.tensor(rng.standard_normal((5, nc)))
    Y = torch.tensor(rng.standard_normal((5, nr)))
    mx = kernels.coo_spmv_batch_plain(M.row_ptr, M.row_idx, M.row_vals, X,
                                      M.row_seg)
    my = kernels.coo_spmv_batch_plain(M.col_ptr, M.col_idx, M.col_vals, Y,
                                      M.col_seg)
    assert torch.equal(M.matvec_batch(X), mx)
    assert torch.equal(M.rmatvec_batch(Y), my)
    for i in range(5):
        assert torch.equal(mx[i], M.matvec(X[i]))
        assert torch.equal(my[i], M.rmatvec(Y[i]))
