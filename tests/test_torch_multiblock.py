"""Multi-block, SOC and LP problems in the PyTorch port against the JAX
package.

* kernel K4's plain version (the update and the symmetrisation of every
  square block of a block table) and kernel K13's (the projection of every
  SOC block and the largest cone gap) against the JAX update
  (solver.py:308, cones.py:172-173) and ``soc_projection_block``
  (cones.py:43-56) with its gap (solver.py:414-419);
* the f64 iterates after 50 iterations from one ``init_state`` on a
  program with two grouped side-3 PSD blocks (one batched eigh), two single
  blocks, three SOC blocks and LP coordinates (rtol 1e-9, atol 1e-11, as
  tests/test_torch_iteration.py holds the single block);
* the feasible conformance problems of tests/test_conformance.py
  (``TestLP``, ``TestSOC``, ``TestRotatedSOC``, ``TestPSD``) built through
  both packages and solved under the default ``Options()``: status equal,
  objective within 2e-4 (1 + |obj|).

The JAX side runs on the CPU as its own tests run it; the port takes
``device="cpu"``, where every kernel wrapper runs its plain version.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import chip_smoke
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.ops.cones import soc_projection_block
from proxsdp_tpu.problem import preprocess as j_pre, to_square_form as j_sq
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver

F64 = torch.float64

# grouped side-3 blocks, single sides 5 and 6, SOC blocks, LP coordinates
SMALL = dict(seed=1, sides=(3, 5, 3, 6), soc_lens=(4, 5, 4), n_lp=6,
             rows=14, density=0.3)


def jstate(host: dict):
    return jsolver.State(**{
        k: (tuple(jnp.asarray(w) for w in v) if k == "warm" else jnp.asarray(v))
        for k, v in host.items()})


@pytest.mark.parametrize("sides, n_free", [((3, 4), 5), ((2, 2, 5), 0),
                                           ((1, 3), 2)])
def test_primal_update_sym_blocks_match_jax(sides, n_free):
    n = sum(s * s for s in sides) + n_free
    rng = np.random.RandomState(n)
    x, Mty, c = rng.randn(n), rng.randn(n), rng.randn(n)
    ps = 0.43
    u = np.asarray(jnp.asarray(x) - ps * (jnp.asarray(Mty) + jnp.asarray(c)))
    want, off = u.copy(), 0
    for s in sides:
        X = jnp.asarray(u[off : off + s * s]).reshape(s, s)
        want[off : off + s * s] = np.asarray(0.5 * (X + X.T)).reshape(-1)
        off += s * s
    t = functools.partial(torch.tensor, dtype=F64)
    got = kernels.primal_update_sym(t(x), t(Mty), t(c), t(ps), sides)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=1e-16)


def _soc_blocks(rng, lens):
    """SOC blocks of ``lens`` in the three cases and with v = 0: inside
    (|v| < s), in the polar cone (|v| <= -s), outside, v = 0 with s < 0."""
    out = []
    for i, ln in enumerate(lens):
        v = rng.randn(ln - 1)
        nv = np.linalg.norm(v)
        s = {0: 2.0 * nv, 1: -1.5 * nv, 2: 0.3 * nv, 3: -0.7}[i % 4]
        if i % 4 == 3:
            v = np.zeros(ln - 1)
        out.append(np.concatenate([[s], v]))
    return np.concatenate(out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_soc_projection_matches_jax(dtype):
    """Every case of cones.py:50-55 at lengths 2-70 (one and several
    32-element rounds of a warp), and the gap of solver.py:418."""
    rng = np.random.RandomState(3)
    lens = tuple(2 + (7 * i) % 69 for i in range(24)) + (1,)
    v = _soc_blocks(rng, lens)
    got, gap = kernels.soc_projection(torch.tensor(v, dtype=dtype), lens)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    want, gaps, off = [], [], 0
    for ln in lens:
        proj = soc_projection_block(jnp.asarray(v[off : off + ln], jdt))
        want.append(np.asarray(proj))
        gaps.append(float(jnp.sqrt(jnp.sum(proj[1:] * proj[1:])) - proj[0]))
        off += ln
    tol = dict(rtol=1e-14, atol=1e-15) if dtype == torch.float64 else \
        dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.concatenate(want), **tol)
    np.testing.assert_allclose(float(gap), max(gaps), **tol)
    # the cases: the polar blocks went to 0, the inside ones stayed
    off = 0
    for i, ln in enumerate(lens[:-1]):
        blk = got[off : off + ln].double().numpy()
        if i % 4 == 1:
            assert not blk.any()
        if i % 4 == 0:
            np.testing.assert_array_equal(blk, np.asarray(
                torch.tensor(v[off : off + ln], dtype=dtype).double()))
        off += ln


def test_soc_projection_plain_sums_in_the_kernels_order():
    """The plain version's norm repeats soc_proj.cu's order (lane l adds
    entries l, l + 32, ..., then the shuffle tree): on a block whose terms
    cancel in f32, that order and no other gives its bits."""
    v = np.concatenate([[0.0], np.tile([1e8, 1.0, -1e8, 3.0], 40)])
    V = torch.tensor(v[1:], dtype=torch.float32)[None, :]
    sq = (V * V)[0]
    lanes = [sq[i::32] for i in range(32)]
    acc = torch.stack([functools.reduce(lambda a, b: a + b, lane)
                       for lane in lanes])
    for half in (16, 8, 4, 2, 1):
        acc = acc[:half] + acc[half : 2 * half]
    assert torch.equal(kernels._warp_sq_norms(V)[0], acc[0])


def _setups(kw):
    data = chip_smoke.conic_program_data(**kw)
    pj = chip_smoke.build_conic_program(jx, data)[0]
    pt = chip_smoke.build_conic_program(tx, data)[0]
    return j_sq(j_pre(pj)), pj, pt


@functools.lru_cache(maxsize=None)
def _stepped(k: int):
    setup = _setups(SMALL)[0]
    layout = setup.layout
    jopts, topts = tp.jax_opts(), tp.torch_opts()
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, setup))
    o_j = tp.jax_operands(setup)
    o_t = tp.torch_operands_from_jax(o_j, setup)
    it_j = tp.jax_iteration(layout, jopts)
    it_t = tsolver.make_chunk_runner(layout, topts, device=tp.DEV)[1]
    s_j, s_t = jstate(host), convert.state_from_numpy(host, tp.DEV)
    for _ in range(k):
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t)
    return convert.state_to_numpy(s_t), tp.jax_state_numpy(s_j), layout


@pytest.mark.parametrize("k", [1, 50])
def test_multiblock_iterates_match_jax(k):
    got, want, layout = _stepped(k)
    assert layout.sdp_sides == (3, 5, 3, 6) and layout.soc_lens == (4, 5, 4)
    assert tsolver.block_plan(layout, tp.torch_opts()).groups == [
        (3, [(0, 0), (2, 34)])]
    tp.assert_states_close(got, want, offsets=layout.sdp_offsets)
    assert np.isfinite(float(want["max_soc_gap"]))


def test_multiblock_state_round_trip():
    """A multi-block state (one warm vector per block) crosses both ways."""
    _, want, _ = _stepped(1)
    back = convert.state_to_numpy(convert.state_from_numpy(want, "cpu"))
    tp.assert_states_close(back, want, rtol=0, atol=0,
                           offsets=_stepped(1)[2].sdp_offsets)


def test_multiblock_default_solve_matches_jax():
    """The default solve (probe gate, hybrid race over every block kind,
    f64 polish) of the small program: status, objective, cone membership."""
    data = chip_smoke.conic_program_data(**SMALL)
    pj = chip_smoke.build_conic_program(jx, data)[0]
    pt, Xs, socs, _ = chip_smoke.build_conic_program(tx, data)
    rj = jx.solve(pj, jx.Options())
    rt = tx.solve(pt, tx.Options(), device="cpu")
    assert rt.status == rj.status == 1
    assert abs(rt.objval - rj.objval) <= 2e-4 * (1 + abs(rj.objval))
    for X in Xs:
        Xm = rt.primal[X]
        assert np.linalg.eigvalsh(Xm)[0] >= -1e-6 * np.linalg.norm(Xm)
    for s in socs:
        assert np.linalg.norm(rt.primal[s][1:]) - rt.primal[s][0] <= 1e-6


# ---- the feasible conformance problems of tests/test_conformance.py


def _lp(pkg, rows, obj, sense="min", constant=0.0, nvars=1, eq=()):
    o = pkg.Optimizer()
    o.add_free_vars(nvars)
    for coeffs, rhs in eq:
        o.add_eq_constraint(coeffs, rhs)
    for coeffs, rhs in rows:
        o.add_ineq_constraint(coeffs, rhs)
    o.set_objective(obj, sense=sense, constant=constant)
    return o.build_problem()


def _soc_norm_min(pkg):
    o = pkg.Optimizer()
    s = o.add_soc_var(3)
    o.add_eq_constraint({int(s[1]): 1.0}, 3.0)
    o.add_eq_constraint({int(s[2]): 1.0}, 4.0)
    o.set_objective({int(s[0]): 1.0})
    return o.build_problem()


def _soc_disk(pkg):
    o = pkg.Optimizer()
    s = o.add_soc_var(3)
    o.add_eq_constraint({int(s[0]): 1.0}, np.sqrt(2.0))
    o.set_objective({int(s[1]): 1.0, int(s[2]): 1.0}, sense="max")
    return o.build_problem()


def _soc_dim2(pkg):
    o = pkg.Optimizer()
    s = o.add_soc_var(2)
    o.add_eq_constraint({int(s[1]): 1.0}, 2.0)
    o.set_objective({int(s[0]): 1.0})
    return o.build_problem()


def _soc_two_blocks(pkg):
    o = pkg.Optimizer()
    s1, s2 = o.add_soc_var(2), o.add_soc_var(2)
    o.add_eq_constraint({int(s1[1]): 1.0}, 3.0)
    o.add_eq_constraint({int(s2[1]): 1.0}, 4.0)
    o.set_objective({int(s1[0]): 1.0, int(s2[0]): 1.0})
    return o.build_problem()


def _soc_mixed_lp(pkg):
    o = pkg.Optimizer()
    s = o.add_soc_var(3)
    (z,) = o.add_free_vars(1)
    o.add_eq_constraint({int(s[1]): 1.0}, 1.0)
    o.add_eq_constraint({int(s[2]): 1.0}, 1.0)
    o.add_ineq_constraint({int(z): -1.0}, -2.0)
    o.set_objective({int(s[0]): 1.0, int(z): 1.0})
    return o.build_problem()


def _rsoc(pkg, eqs, obj, sense="min"):
    o = pkg.Optimizer()
    uvw = [int(v) for v in o.add_rsoc_var(3)]
    for coeffs, rhs in eqs(uvw):
        o.add_eq_constraint(coeffs, rhs)
    o.set_objective(obj(uvw), sense=sense)
    return o.build_problem()


def _psd(pkg, side, eqs=(), ineqs=(), obj=None, sense="min", blocks=1):
    o = pkg.Optimizer()
    Xs = [o.add_psd_var(side) for _ in range(blocks)]
    for fn, rhs in eqs:
        o.add_eq_constraint(fn(o, Xs), rhs)
    for fn, rhs in ineqs:
        o.add_ineq_constraint(fn(o, Xs), rhs)
    o.set_objective(obj(o, Xs), sense=sense)
    return o.build_problem()


def _psd_shared_bridge(pkg):
    o = pkg.Optimizer()
    X = o.add_psd_var(2)
    s = o.add_soc_var(2)
    o.add_eq_constraint({int(X[0, 0]): 1.0, int(s[0]): -1.0}, 0.0)
    o.add_eq_constraint({int(s[1]): 1.0}, 2.0)
    o.set_objective({int(X[0, 0]): 1.0, int(X[1, 1]): 1.0})
    return o.build_problem()


def _psd_correlation(pkg):
    C = np.array([[1.0, 0.5, -0.2], [0.5, 1.0, 0.3], [-0.2, 0.3, 1.0]])
    o = pkg.Optimizer()
    X = o.add_psd_var(3)
    for i in range(3):
        o.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    o.set_objective(o.psd_inner_product_coeffs(X, C))
    return o.build_problem()


_C2 = np.array([[2.0, 1.0], [1.0, 2.0]])
CONFORMANCE = {
    "lp_min_bound": lambda p: _lp(p, [({0: -1.0}, -1.0)], {0: 1.0}),
    "lp_max_two_vars": lambda p: _lp(
        p, [({0: 1.0, 1: 2.0}, 3.0), ({0: 1.0}, 1.0), ({0: -1.0}, 0.0),
            ({1: -1.0}, 0.0)], {0: 1.0, 1: 1.0}, "max", nvars=2),
    "lp_equality": lambda p: _lp(
        p, [({0: -1.0}, 0.0), ({1: -1.0}, 0.0)], {0: 1.0, 1: 2.0}, nvars=2,
        eq=[({0: 1.0, 1: 1.0}, 1.0)]),
    "lp_interval_min": lambda p: _lp(
        p, [({0: 1.0}, 2.0), ({0: -1.0}, -1.0)], {0: 1.0}),
    "lp_interval_max": lambda p: _lp(
        p, [({0: 1.0}, 2.0), ({0: -1.0}, -1.0)], {0: 1.0}, "max"),
    "lp_greater_than": lambda p: _lp(p, [({0: -1.0}, -3.0)], {0: 1.0}),
    "lp_objective_constant": lambda p: _lp(
        p, [({0: -1.0}, -1.0)], {0: 1.0}, constant=5.0),
    "lp_max_with_constant": lambda p: _lp(
        p, [({0: -1.0}, -1.0)], {0: -1.0}, "max", constant=2.0),
    "lp_feasibility": lambda p: _lp(p, [], {}, eq=[({0: 1.0}, 1.0)]),
    "lp_two_eq_unique": lambda p: _lp(
        p, [], {0: 1.0, 1: 1.0}, nvars=2,
        eq=[({0: 1.0, 1: 1.0}, 3.0), ({0: 1.0, 1: -1.0}, 1.0)]),
    "lp_duals": lambda p: _lp(
        p, [({0: -1.0}, 0.0), ({1: -1.0}, 0.0)], {0: 1.0, 1: 3.0}, nvars=2,
        eq=[({0: 1.0, 1: 1.0}, 1.0)]),
    "soc_norm_min": _soc_norm_min,
    "soc_max_sum_on_disk": _soc_disk,
    "soc_dim2": _soc_dim2,
    "soc_two_blocks": _soc_two_blocks,
    "soc_mixed_with_lp": _soc_mixed_lp,
    "rsoc_basic": lambda p: _rsoc(
        p, lambda u: [({u[1]: 1.0}, 1.0), ({u[2]: 1.0}, 2.0)],
        lambda u: {u[0]: 1.0}),
    "rsoc_sqrt": lambda p: _rsoc(
        p, lambda u: [({u[0]: 1.0}, 1.0), ({u[1]: 1.0}, 0.5)],
        lambda u: {u[2]: 1.0}, "max"),
    "rsoc_harmonic": lambda p: _rsoc(
        p, lambda u: [({u[2]: 1.0}, 2.0), ({u[0]: 1.0, u[1]: -1.0}, 0.0)],
        lambda u: {u[0]: 1.0, u[1]: 1.0}),
    "psd_trace_min": lambda p: _psd(
        p, 2, eqs=[(lambda o, X: {int(X[0][0, 0]): 1.0}, 1.0)],
        obj=lambda o, X: {int(X[0][0, 0]): 1.0, int(X[0][1, 1]): 1.0}),
    "psd_2x2_known_answer": lambda p: _psd(
        p, 2, eqs=[(lambda o, X: {int(X[0][0, 1]): 1.0}, 1.0)],
        obj=lambda o, X: {int(X[0][0, 0]): 1.0, int(X[0][1, 1]): 1.0}),
    "psd_min_eig": lambda p: _psd(
        p, 2, eqs=[(lambda o, X: o.psd_inner_product_coeffs(X[0], np.eye(2)),
                    1.0)],
        obj=lambda o, X: o.psd_inner_product_coeffs(X[0], _C2)),
    "psd_max_eig": lambda p: _psd(
        p, 2, eqs=[(lambda o, X: o.psd_inner_product_coeffs(X[0], np.eye(2)),
                    1.0)],
        obj=lambda o, X: o.psd_inner_product_coeffs(X[0], _C2), sense="max"),
    "psd_inequality_rows": lambda p: _psd(
        p, 2, ineqs=[(lambda o, X: {int(X[0][0, 0]): -1.0,
                                    int(X[0][1, 1]): -1.0}, -2.0)],
        obj=lambda o, X: {int(X[0][0, 0]): 1.0, int(X[0][1, 1]): 1.0}),
    "psd_two_blocks_coupled": lambda p: _psd(
        p, 2, blocks=2,
        eqs=[(lambda o, X: {int(X[0][0, 0]): 1.0, int(X[1][0, 0]): 1.0}, 2.0)],
        obj=lambda o, X: {int(X[b][i, i]): 1.0 for b in (0, 1) for i in (0, 1)}),
    "psd_shared_variable_bridge": _psd_shared_bridge,
    "psd_1x1": lambda p: _psd(
        p, 1, eqs=[(lambda o, X: {int(X[0][0, 0]): 1.0}, 3.0)],
        obj=lambda o, X: {int(X[0][0, 0]): 1.0}),
    "psd_correlation_matrix_min": _psd_correlation,
}


@pytest.mark.parametrize("name", list(CONFORMANCE))
def test_conformance_problem_matches_jax(name):
    build = CONFORMANCE[name]
    rj = jx.solve(build(jx), jx.Options())
    rt = tx.solve(build(tx), tx.Options(), device="cpu")
    assert rt.status == rj.status == 1, (rt.status_string, rj.status_string)
    assert abs(rt.objval - rj.objval) <= 2e-4 * (1 + abs(rj.objval)), (
        rt.objval, rj.objval)
