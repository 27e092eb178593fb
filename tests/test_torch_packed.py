"""The packed-triangle layout (``Options(square_form=False)``) of the port
against the JAX package's.

The packed layout keeps each PSD block as its scaled upper triangle: the
primal update symmetrises nothing (K4 with an empty block table), each
block goes through K10's ``tri_to_square`` before its projection and
``square_to_tri`` after it (cones.py:166-174), a group of same-side small
blocks stays packed through ``psd_projection_small_batch``, and the
residuals take no sqrt(2) weights (solver.py:546-555).  Tolerances:

* the f64 program's iterates after 100 iterations from one
  ``init_state``: every State field to rtol 1e-9, atol 1e-11
  (``test_torch_iteration.py``'s bound), for max-cut at side 50, the
  two-block problem, a PSD + SOC + LP mix and a grouped-block program;
* whole solves (``test_square_form.py::TestSolveEquivalence``'s cases
  under their options): the same status, objectives within 1e-4 and
  iterations within 2 of each other in the two layouts and of the JAX
  package's packed-layout solve.
"""

import functools

import jax
import numpy as np
import pytest

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.problem import preprocess
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver

ITERS = 100


def _two_blocks(pkg, **kw):
    """test_square_form.py::test_two_blocks_square: min X01 + Y01 + Y12
    with unit diagonals, optimum -3 (the Optimizer)."""
    opt = pkg.Optimizer(tol_gap=1e-6, tol_feasibility=1e-6, **kw)
    X = opt.add_psd_var(2)
    Y = opt.add_psd_var(3)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
    for i in range(3):
        opt.add_eq_constraint({int(Y[i, i]): 1.0}, 1.0)
    opt.set_objective({int(X[0, 1]): 1.0, int(Y[0, 1]): 1.0,
                       int(Y[1, 2]): 1.0}, sense="min")
    return opt


def _sdp_soc(pkg, **kw):
    """test_square_form.py::test_mixed_sdp_soc_square, optimum 1 (the
    Optimizer)."""
    opt = pkg.Optimizer(**kw)
    X = opt.add_psd_var(2)
    s = opt.add_soc_var(2)
    opt.add_eq_constraint({int(X[0, 0]): 1.0}, 1.0)
    opt.add_eq_constraint({int(X[1, 1]): 1.0}, 1.0)
    opt.add_eq_constraint({int(s[1]): 1.0}, 2.0)
    opt.set_objective({int(X[0, 1]): 1.0, int(s[0]): 1.0}, sense="min")
    return opt


def _mix(pkg):
    """A seeded PSD + SOC + LP program: a side-12 block, an SOC block of
    length 5 and 6 LP coordinates, random equality rows and inequality
    rows on the LP part."""
    rng = np.random.RandomState(3)
    opt = pkg.Optimizer()
    X = opt.add_psd_var(12)
    s = opt.add_soc_var(5)
    z = opt.add_free_vars(6)
    xs = [int(X[i, j]) for i in range(12) for j in range(i, 12)]
    for r in range(10):
        cols = rng.choice(len(xs), 6, replace=False)
        row = {xs[c]: float(rng.randn()) for c in cols}
        row[int(s[r % 5])] = 1.0
        row[int(z[r % 6])] = 0.5
        opt.add_eq_constraint(row, float(rng.randn()))
    for i in range(12):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.add_eq_constraint({int(s[0]): 1.0}, 2.0)
    for j in range(6):
        opt.add_ineq_constraint({int(z[j]): 1.0}, 1.0)
        opt.add_ineq_constraint({int(z[j]): -1.0}, 1.0)
    C = rng.randn(12, 12)
    opt.set_objective({**opt.psd_inner_product_coeffs(X, C + C.T),
                       int(s[0]): 1.0,
                       **{int(z[j]): float(rng.randn()) for j in range(6)}})
    return opt.build_problem()


def _grouped(pkg):
    """Three side-6 blocks (one K9 group in the plan) and one of side 9,
    coupled by random rows; unit diagonals keep it bounded."""
    rng = np.random.RandomState(5)
    opt = pkg.Optimizer()
    blocks = [opt.add_psd_var(6) for _ in range(3)] + [opt.add_psd_var(9)]
    obj = {}
    for X in blocks:
        n = X.shape[0]
        for i in range(n):
            opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
        C = rng.randn(n, n)
        obj.update(opt.psd_inner_product_coeffs(X, C + C.T))
    for _ in range(4):
        row = {int(b[0, 1]): float(rng.randn()) for b in blocks}
        opt.add_eq_constraint(row, 0.1 * float(rng.randn()))
    opt.set_objective(obj)
    return opt.build_problem()


PROGRAMS = {"two_blocks": lambda pkg: _two_blocks(pkg).build_problem(),
            "mix": _mix, "grouped": _grouped}


@functools.lru_cache(maxsize=None)
def _setup(name: str):
    if name in PROGRAMS:
        return preprocess(PROGRAMS[name](jx))
    return tp.jax_setup(name, square_form=False)


@functools.lru_cache(maxsize=None)
def _steps(name: str):
    """(port fields, JAX fields) after ITERS f64 iterations from one
    init_state in the packed layout."""
    setup = _setup(name)
    layout = setup.layout
    assert not layout.square_form
    jopts = tp.jax_opts(square_form=False)
    topts = tp.torch_opts(square_form=False)
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, setup))
    o_j = tp.jax_operands(setup)
    o_t = tp.torch_operands_from_jax(o_j, setup)
    it_j = tp.jax_iteration(layout, jopts)
    it_t = tsolver.make_chunk_runner(layout, topts, device=tp.DEV)[1]
    s_j = jax.tree_util.tree_map(jax.numpy.asarray,
                                 jsolver.init_state(layout, jopts, setup))
    s_t = convert.state_from_numpy(host, tp.DEV)
    kernels.reset_launch_counts()
    for _ in range(ITERS):
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t)
    return convert.state_to_numpy(s_t), tp.jax_state_numpy(s_j)


@pytest.mark.parametrize("name", ["maxcut50", "two_blocks", "mix", "grouped"])
def test_packed_iterates_match_jax(name):
    got, want = _steps(name)
    layout = _setup(name).layout
    assert int(got["iter"]) == ITERS
    tp.assert_states_close(got, want, offsets=layout.sdp_offsets,
                           square_form=False)
    assert all(v == 0 for v in kernels.launch_counts.values())


def test_grouped_plan_is_packed():
    """The grouped program really groups: its three side-6 blocks are one
    group of the plan, projected from packed rows."""
    layout = _setup("grouped").layout
    plan = tsolver.block_plan(layout, tp.torch_opts(square_form=False))
    assert [(side, len(b)) for side, b in plan.groups] == [(6, 3)]
    assert layout.sdp_blk_lens == (21, 21, 21, 45)


def _maxcut_readme(pkg, **kw):
    """test_square_form.py's _maxcut_opt: the README max-cut at 1e-6 (the
    Optimizer)."""
    opt = pkg.Optimizer(tol_gap=1e-6, tol_feasibility=1e-6, **kw)
    X = opt.add_psd_var(4)
    for i in range(4):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * tp.README_W),
                      sense="max")
    return opt


SOLVES = {
    "readme": (_maxcut_readme, 18.0, 1e-3),
    "sdp_soc": (_sdp_soc, 1.0, 2e-2),
    "two_blocks": (_two_blocks, -3.0, 2e-2),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solves_in_both_layouts_match_jax(name):
    """TestSolveEquivalence's cases through ``optimize`` under their
    Optimizer's options: the port in both layouts and the JAX package in
    the packed one."""
    build, opt_val, tol = SOLVES[name]
    r_sq = build(tx).optimize(device="cpu")
    r_tri = build(tx, square_form=False).optimize(device="cpu")
    r_jax = build(jx, square_form=False).optimize()
    assert r_sq.status == r_tri.status == r_jax.status == 1
    assert abs(r_tri.objval - opt_val) < tol
    assert abs(r_sq.objval - r_tri.objval) < 1e-4
    assert abs(r_tri.objval - r_jax.objval) < 1e-4
    assert abs(r_sq.iter - r_tri.iter) <= 2
    assert abs(r_tri.iter - r_jax.iter) <= 2
    np.testing.assert_allclose(r_tri.primal, r_jax.primal, atol=1e-3)


def test_readme_packed_f64_program_matches_jax():
    """The README max-cut's f64 program in the packed layout repeats the
    JAX package's solve: status, iterations, objective to 1e-9."""
    rj = jx.solve(tp.build_problem(jx, "readme"), tp.jax_opts(square_form=False))
    rt = tx.solve(tp.build_problem(tx, "readme"),
                  tp.torch_opts(square_form=False), device="cpu")
    assert rt.status == rj.status == 1
    assert rt.iter == rj.iter
    assert abs(rt.objval - rj.objval) <= 1e-9 * (1 + abs(rj.objval))


def test_packed_warm_start():
    """test_square_form.py::test_warm_start_square in the packed layout:
    a warm start from the first solve takes no more iterations, in both
    packages, and the f64 warm solve repeats the JAX package's."""
    r1 = _maxcut_readme(tx, square_form=False).optimize(device="cpu")
    r2 = _maxcut_readme(tx, square_form=False).optimize(r1, device="cpu")
    assert r2.status == 1 and r2.iter <= r1.iter
    assert abs(r2.objval - 18.0) < 1e-3
    j1 = _maxcut_readme(jx, square_form=False).optimize()
    j2 = _maxcut_readme(jx, square_form=False).optimize(warm_start=j1)
    assert j2.status == 1 and abs(r2.iter - j2.iter) <= 2
    # the f64 program from one warm start (the JAX package's first answer,
    # as a user-space tuple)
    w = (j1.primal, j1.dual_eq, j1.dual_in)
    w64_t = _maxcut_readme(tx, square_form=False,
                           hybrid_precision=False).optimize(w, device="cpu")
    w64_j = _maxcut_readme(jx, square_form=False,
                           hybrid_precision=False).optimize(warm_start=w)
    assert w64_t.status == w64_j.status == 1
    assert w64_t.iter == w64_j.iter
    assert abs(w64_t.objval - w64_j.objval) <= 1e-9 * (1 + abs(w64_j.objval))


def test_packed_layout_reaches_the_square_answer_side40():
    """A subspace program at side 40 (the sign-free f32 race enters its
    subspace step) in both layouts of the port and the JAX package's
    packed one: status 1, objectives within 1e-4 (1 + |obj|)."""
    from proxsdp_tpu.models.maxcut import maxcut_problem as jmc
    from proxsdp_tpu.models.maxcut import random_graph_weights as jrw
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem as tmc
    from proxsdp_tpu_torch.models.maxcut import random_graph_weights as trw

    kw = dict(chunk_iters=64, race_subspace_warmup=64)
    r_sq = tx.solve(tmc(trw(1, 40))[0], tx.Options(**kw), device="cpu")
    r_tri = tx.solve(tmc(trw(1, 40))[0], tx.Options(square_form=False, **kw),
                     device="cpu")
    r_jax = jx.solve(jmc(jrw(1, 40))[0], jx.Options(square_form=False, **kw))
    assert r_sq.status == r_tri.status == r_jax.status == 1
    bound = 1e-4 * (1 + abs(r_jax.objval))
    assert abs(r_tri.objval - r_jax.objval) <= bound
    assert abs(r_sq.objval - r_tri.objval) <= bound
