"""The sign-based subspace step (``subspace_sign=True``, kernel K17's plain
version) and the accept-always step in ``solve`` (``subspace_accept_always
=True``, kernel K12's plain version at B = 1) against the JAX package's.

* the sign body (cones.py:337-425) on one X, basis and accept_tol in f32
  at side 100, k = 12 and 24, accepted and rejected: the projection Xp =
  Q Bp Q^T within 1e-5 of ||Xp||_F (f32 products summed in other orders),
  the same accept decision and rank, the statistics to 1e-4; K17's plain
  twin's Bp against a transcription of cones.py:349-399 on the same Q and
  Z within 1e-5 relative;
* the gate (cones.py:317-321): an f64 or mixed program with
  ``subspace_sign=True`` runs the eigh body unchanged;
* ``test_square_form.py``'s two sign tests through the port, held to the
  JAX run's statuses and to their bounds;
* the accept-always step in ``solve``: 100 iterations of the f64 program
  (``subspace_mixed=False``) at side 50 in both layouts against the JAX
  package's, every field to rtol 1e-9 (``test_torch_iteration.py``'s
  bound), lined up for ROADMAP C11: after iteration 1 the JAX run gets
  the port's basis (the JAX step zeroes a basis on the cold start's X =
  0, the port keeps it).  The mixed program (an f32 basis) is held a step
  at a time along the port's trajectory, within 1e-5 of each field's
  scale: its Ritz vectors are f32 products and an f32 eigh, whose
  rounding differs between the builds and compounds over 100 iterations
  to ~4e-4 of x's scale;
* whole f64 solves with the accept-always step in both layouts: status,
  objective within 1e-4 (1 + |obj|), iterations within 5 %.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.ops import cones as jcones
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.ops import cones as tcones

SIDE = 100


def _spectrum(seed=5, npos=8):
    """(X, V): X = V diag(w) V^T, npos eigenvalues in [2, 10] and a negative
    bulk in [-3, -0.1], V's columns by descending w."""
    rng = np.random.RandomState(seed)
    V, _ = np.linalg.qr(rng.randn(SIDE, SIDE))
    w = np.concatenate([np.linspace(10.0, 2.0, npos),
                        -np.linspace(0.1, 3.0, SIDE - npos)])
    return (V * w) @ V.T, V


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _step(k, *, accept_tol, force_full=False, warm_noise=0.0, dtype="float32",
          sign=True, X=None):
    Xm, V = _spectrum()
    X = Xm if X is None else X
    warm = V[:, :k] + warm_noise * np.random.RandomState(6).randn(SIDE, k)
    np_dt = np.float32 if dtype == "float32" else np.float64
    X, warm = X.astype(np_dt), warm.astype(np_dt)
    kw = dict(dtype=dtype, subspace_rank=k, subspace_fallback="polar",
              projection="polar", subspace_sign=sign)
    at = None if accept_tol is None else np.asarray(accept_tol, np_dt)
    want = jcones.psd_projection_block(
        jnp.asarray(X.reshape(-1)), SIDE, jnp.asarray(2, jnp.int32),
        jnp.asarray(warm), opt=jx.Options(**kw), allow_lanczos=True,
        accept_tol=None if at is None else jnp.asarray(at),
        force_full=jnp.asarray(force_full))
    got = tcones.psd_projection_block(
        torch.tensor(X), torch.tensor(warm), opts=tx.Options(**kw),
        accept_tol=None if at is None else torch.tensor(at),
        force_full=force_full)
    return got, want


CASES = {
    "accept": dict(accept_tol=1e-3),
    "reject_resid": dict(accept_tol=None, warm_noise=0.3),
    "force_full": dict(accept_tol=1e-3, force_full=True),
}


@pytest.mark.parametrize("k", [12, 24])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sign_body_matches_jax(case, k):
    got, want = _step(k, **CASES[case])
    accepted = case == "accept"
    assert bool(got.used_full) == bool(want.used_full) == (not accepted)
    assert int(got.current_rank) == int(want.current_rank) == 8
    assert _rel(got.block.numpy(),
                np.asarray(want.block).reshape(SIDE, SIDE)) <= 1e-5
    np.testing.assert_allclose(got.sub_stats.numpy(), np.asarray(want.sub_stats),
                               rtol=1e-4, atol=1e-5)
    if accepted:  # the new basis is Q itself: the same span
        gw, ww = got.warm.numpy(), np.asarray(want.warm)
        np.testing.assert_allclose(gw @ gw.T, ww @ ww.T, rtol=0, atol=1e-5)


def _jax_sign_bp(Q, Z, k, aggressive=7, polish=4):
    """cones.py:351-399 transcribed: Bp and npos of the sign body."""
    P = jcones.POLAR_QA, jcones.POLAR_QB, jcones.POLAR_QC
    with jax.default_matmul_precision("float32"):
        B = Q.T @ Z
        B = 0.5 * (B + B.T)
        Y = B / (jnp.sqrt(jnp.sum(B * B)) + jnp.asarray(1e-30, B.dtype))
        for _ in range(aggressive):
            A2 = Y @ Y
            Y = P[0] * Y + Y @ (P[1] * A2 + P[2] * (A2 @ A2))
        for _ in range(polish):
            Y = 1.5 * Y - 0.5 * (Y @ (Y @ Y))
        S = 0.5 * (Y + Y.T)
        Bp = 0.5 * (B + S @ B)
        return 0.5 * (Bp + Bp.T), 0.5 * (k + jnp.trace(S))


@pytest.mark.parametrize("k", [12, 24])
def test_sign_kernel_plain_bp_matches_jax(k):
    """K17's plain twin (the CPU path and the card's oracle) on the
    port's own Q and Z against the transcription: Bp within 1e-5."""
    Xm, V = _spectrum()
    X = torch.tensor(Xm, dtype=torch.float32)
    warm = torch.tensor(V[:, :k] + 0.05 * np.random.RandomState(1).randn(SIDE, k),
                        dtype=torch.float32)
    Q = tcones._cholqr2(X @ warm)
    Z = X @ Q
    Bp, stats, info = kernels.subspace_sign(Q, Z, None, 1e-9, 7, 4, False)
    want_bp, want_npos = _jax_sign_bp(jnp.asarray(Q.numpy()),
                                      jnp.asarray(Z.numpy()), k)
    assert _rel(Bp.numpy(), want_bp) <= 1e-5
    assert abs(float(stats[2]) - float(want_npos)) <= 1e-4
    assert int(info[1]) == round(float(want_npos)) == 8
    assert int(info[2]) == 0


def test_sign_kernel_flags_on_non_finite_and_rank_deficient_inputs():
    """A NaN in Z: rejected, rank 0, the non-finite flag set.  A basis
    with a zero column (rank-deficient Q): finite, and the flags follow
    the test as the JAX body computes it."""
    Xm, V = _spectrum()
    X = torch.tensor(Xm, dtype=torch.float32)
    Q = torch.tensor(V[:, :12], dtype=torch.float32)
    Z = X @ Q
    Zn = Z.clone()
    Zn[3, 2] = torch.nan
    _, stats, info = kernels.subspace_sign(Q, Zn, None, 1e-9, 7, 4, False)
    assert info.tolist() == [0, 0, 1]
    assert torch.isnan(stats).all()
    Qd = Q.clone()
    Qd[:, 5] = 0.0
    Bp, stats, info = kernels.subspace_sign(Qd, X @ Qd, torch.tensor(
        1e-3, dtype=torch.float32), 1e-9, 7, 4, False)
    want_bp, want_npos = _jax_sign_bp(jnp.asarray(Qd.numpy()),
                                      jnp.asarray((X @ Qd).numpy()), 12)
    assert torch.isfinite(Bp).all() and info[2] == 0
    assert _rel(Bp.numpy(), want_bp) <= 1e-5
    assert abs(float(stats[2]) - float(want_npos)) <= 1e-4


def test_sign_kernel_takes_f32_only():
    Q = torch.zeros(20, 4, dtype=torch.float64)
    with pytest.raises(TypeError, match="f32 only"):
        kernels.subspace_sign(Q, Q, None, 1e-9, 7, 4, False)


@pytest.mark.parametrize("dtype, mixed", [("float64", False),
                                          ("float64", True)])
def test_sign_gate_keeps_the_eigh_body(dtype, mixed):
    """cones.py:317-321: subspace_sign=True in an f64 program (plain or
    mixed) runs the eigh body, bit for bit."""
    Xm, V = _spectrum()
    X = torch.tensor(Xm)
    warm = torch.tensor(V[:, :12])
    outs = []
    for sign in (True, False):
        opts = tx.Options(dtype=dtype, subspace_rank=12, subspace_sign=sign,
                          subspace_mixed=mixed, subspace_fallback="polar")
        outs.append(tcones.psd_projection_block(
            X, warm, opts=opts, accept_tol=torch.tensor(1e-3,
                                                        dtype=torch.float64)))
    for a, b in zip(outs[0], outs[1]):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_sign_gate_off_under_accept_always():
    """subspace_accept_always wins over subspace_sign in f32 (the gate):
    the accept-always step runs, no K17 plain call, no host flag."""
    Xm, V = _spectrum()
    X = torch.tensor(Xm, dtype=torch.float32)
    warm = torch.tensor(V[:, :12], dtype=torch.float32)
    kw = dict(dtype="float32", subspace_rank=12)
    a = tcones.psd_projection_block(X, warm, opts=tx.Options(
        subspace_sign=True, subspace_accept_always=True, **kw))
    b = tcones.psd_projection_block(X, warm, opts=tx.Options(
        subspace_accept_always=True, **kw))
    assert torch.equal(a.block, b.block)
    assert isinstance(a.used_full, torch.Tensor) and not bool(a.used_full)


def _maxcut_readme(pkg, **kw):
    opt = pkg.Optimizer(tol_gap=1e-6, tol_feasibility=1e-6, **kw)
    X = opt.add_psd_var(4)
    for i in range(4):
        opt.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    opt.set_objective(opt.psd_inner_product_coeffs(X, 0.25 * tp.README_W),
                      sense="max")
    return opt


def test_sign_subspace_race():
    """test_square_form.py::test_sign_subspace_race through the port."""
    kw = dict(subspace_sign=True, race_subspace_warmup=8, convergence_check=8,
              chunk_iters=16)
    got = _maxcut_readme(tx, **kw).optimize(device="cpu")
    want = _maxcut_readme(jx, **kw).optimize()
    assert got.status == want.status == 1
    assert abs(got.objval - 18.0) < 1e-3


def test_sign_subspace_matches_eigh_subspace():
    """test_square_form.py::test_sign_subspace_matches_eigh_subspace
    through the port: the forced f32 subspace program at side 40, sign and
    eigh bodies, both status 1 as in the JAX runs, the same optimum within
    5e-2 (1 + |obj|), the sign run within 3x the eigh run's iterations."""
    base = dict(dtype="float32", hybrid_precision=False, subspace_rank=12,
                subspace_fallback="polar", tol_gap=1e-3, tol_feasibility=1e-3,
                max_iter=30_000)
    prob_t = tp.tmaxcut.maxcut_problem(tp.tmaxcut.random_graph_weights(3, 40))[0]
    prob_j = tp.jmaxcut.maxcut_problem(tp.jmaxcut.random_graph_weights(3, 40))[0]
    r_sign = tx.solve(prob_t, tx.Options(subspace_sign=True, **base),
                      device="cpu")
    r_eigh = tx.solve(prob_t, tx.Options(**base), device="cpu")
    j_sign = jx.solve(prob_j, jx.Options(subspace_sign=True, **base))
    assert r_sign.status == r_eigh.status == j_sign.status == 1
    assert abs(r_sign.objval - r_eigh.objval) < 5e-2 * max(1.0, abs(r_eigh.objval))
    assert abs(r_sign.objval - j_sign.objval) < 5e-2 * max(1.0, abs(j_sign.objval))
    assert r_sign.iter < 3 * max(r_eigh.iter, 1)


ITERS = 100
K_AA = 8


@functools.lru_cache(maxsize=None)
def _accept_always_steps(square_form: bool, mixed: bool):
    """(port fields, JAX fields) after ITERS iterations of the f64 program
    with the accept-always step at side 50, the JAX run given the port's
    basis after iteration 1 (C11)."""
    setup = tp.jax_setup("maxcut50", square_form=square_form)
    layout = setup.layout
    kw = dict(subspace_rank=K_AA, subspace_accept_always=True,
              subspace_mixed=mixed, square_form=square_form)
    jopts, topts = tp.jax_opts(**kw), tp.torch_opts(**kw)
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, setup))
    o_j = tp.jax_operands(setup)
    o_t = tp.torch_operands_from_jax(o_j, setup)
    it_j = tp.jax_iteration(layout, jopts)
    it_t = tsolver.make_chunk_runner(layout, topts, device=tp.DEV)[1]
    s_j = jax.tree_util.tree_map(jnp.asarray,
                                 jsolver.init_state(layout, jopts, setup))
    s_t = convert.state_from_numpy(host, tp.DEV)
    for k in range(ITERS):
        s_j, s_t = it_j(s_j, o_j), it_t(s_t, o_t)
        if k == 0:  # C11: the port keeps the basis the JAX step zeroes
            assert np.abs(np.asarray(s_j.warm[0])).max() < 1e-5
            s_j = s_j._replace(warm=tuple(jnp.asarray(w.numpy())
                                          for w in s_t.warm))
    return convert.state_to_numpy(s_t), tp.jax_state_numpy(s_j), layout


@pytest.mark.parametrize("square_form", [True, False],
                         ids=["square", "packed"])
def test_accept_always_in_solve_matches_jax(square_form):
    got, want, layout = _accept_always_steps(square_form, False)
    assert int(got["iter"]) == ITERS
    assert got["warm"][0].shape == (50, K_AA)
    tp.assert_states_close(got, want, offsets=layout.sdp_offsets,
                           square_form=square_form)


# the mixed step's tolerance a step, relative to the iterate's largest
# entry: its basis is f32 (cuts of 1e-7 a step in either build)
MIXED_STEP_TOL = 1e-5


@pytest.mark.parametrize("square_form", [True, False],
                         ids=["square", "packed"])
def test_mixed_accept_always_steps_match_jax(square_form):
    """The mixed program (subspace_mixed, an f32 basis) in lock step: for
    each of ITERS iterations along the port's trajectory, one JAX
    iteration from the port's state; the counters equal, x, y, Mx, Mty
    and the step scalars within MIXED_STEP_TOL of their scale, the basis
    spanning the same space (scales: the largest entry before or after
    the step, at least 1e-2: the first step projects the cold start's 0,
    and its M x is 0).  Over 100 iterations the f32 rounding of the
    two builds compounds (to ~4e-4 of x's scale at side 50), so the
    trajectories are held a step at a time, as the batch's mixed step is
    (test_torch_batch_subspace.py's STEP_TOL)."""
    setup = tp.jax_setup("maxcut50", square_form=square_form)
    layout = setup.layout
    kw = dict(subspace_rank=K_AA, subspace_accept_always=True,
              subspace_mixed=True, square_form=square_form)
    jopts, topts = tp.jax_opts(**kw), tp.torch_opts(**kw)
    host = tp.jax_state_numpy(jsolver.init_state(layout, jopts, setup))
    o_j = tp.jax_operands(setup)
    o_t = tp.torch_operands_from_jax(o_j, setup)
    it_j = tp.jax_iteration(layout, jopts)
    it_t = tsolver.make_chunk_runner(layout, topts, device=tp.DEV)[1]
    s_t = convert.state_from_numpy(host, tp.DEV)
    worst = 0.0
    for k in range(ITERS):
        before = convert.state_to_numpy(s_t)
        s_t = it_t(s_t, o_t)
        got = convert.state_to_numpy(s_t)
        want = tp.jax_state_numpy(it_j(jax.tree_util.tree_map(
            jnp.asarray, jsolver.State(**before)), o_j))
        for name in ("iter", "status", "current_rank"):
            np.testing.assert_array_equal(got[name], want[name])
        for name in ("x", "y", "Mx", "Mty", "primal_step", "theta"):
            scale = max(float(np.abs(want[name]).max()),
                        float(np.abs(before[name]).max()), 1e-2)
            err = float(np.abs(got[name] - want[name]).max()) / scale
            worst = max(worst, err)
            assert err <= MIXED_STEP_TOL, (k, name, err)
        if k:  # iteration 1: C11
            g, w = got["warm"][0], want["warm"][0]
            np.testing.assert_allclose(g @ g.T, w @ w.T, rtol=0, atol=1e-4)
    assert worst > 0.0


@pytest.mark.parametrize("square_form", [True, False],
                         ids=["square", "packed"])
def test_accept_always_solve_near_jax(square_form):
    """A whole f64 solve with the accept-always step (subspace_mixed=False)
    at side 50 in either layout: status 1 as the JAX run, the objective
    within 1e-4 (1 + |obj|) and iterations within 5 % of its.  Not lined
    up for C11: the JAX run's basis after iteration 1 is XLA's rounding
    noise on 0 (~1e-14), the port's the old basis, so the paths part."""
    kw = dict(subspace_rank=K_AA, subspace_accept_always=True,
              subspace_mixed=False, square_form=square_form)
    rt = tx.solve(tp.build_problem(tx, "maxcut50"), tp.torch_opts(**kw),
                  device="cpu")
    rj = jx.solve(tp.build_problem(jx, "maxcut50"), tp.jax_opts(**kw))
    assert rt.status == rj.status == 1
    assert abs(rt.objval - rj.objval) <= 1e-4 * (1 + abs(rj.objval))
    assert abs(rt.iter - rj.iter) <= 0.05 * rj.iter
