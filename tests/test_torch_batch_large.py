"""``solve_batch`` past one block's shared memory, and its polar engine, in
the port against the JAX package on the CPU.

On the card the batch driver's eigh mode runs K9 to side 118 (f64) / 168
(f32) and K9L above, the subspace mode K12 where one instance's working
set fits in a block's shared memory and K12L elsewhere, and
``Options(projection="polar")`` the batched polar projection on K5b and
K6b.  On the CPU every wrapper takes its plain version, which has no side
cap, so these tests hold the driver code and the plain versions to the
JAX package: ``polar_psd_batch`` against ``jax.vmap(polar_psd)``; the
polar, eigh and subspace batch programs at sides 100-130; the batch's
equilibration options, which both drivers accept and ignore.  B <= 4, one
torch thread (``_torch_parity``).
"""

import numpy as np
import pytest
import torch

import _torch_parity as tp
import jax
import jax.numpy as jnp
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu.ops import cones as jcones
from proxsdp_tpu.parallel import batch as jbatch
from proxsdp_tpu.problem import preprocess as jpreprocess
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch.ops import cones as tcones
from proxsdp_tpu_torch.parallel import batch as tbatch
from proxsdp_tpu_torch.problem import preprocess
from test_torch_batch_subspace import _jax_logged

# polar_psd_batch against jax.vmap(polar_psd), relative to the largest
# entry: f64 the same products summed in other orders (XLA:CPU runs the
# f64 products in f64 under default_matmul_precision("float32"):
# test_jax_f64_polar_products_are_f64), f32 ~30 products of f32 rounding
POLAR_RTOL = {"float64": 1e-12, "float32": 1e-5}
# f64 programs from one state: the same arithmetic up to summation order
ITER_RTOL = 1e-10
# the hybrid programs' objectives, relative to 1 + |obj| (phase D's bound)
OBJ_RTOL = 2e-4


def _problems(pkg, B, side):
    mod = tp.jmaxcut if pkg is jx else tp.tmaxcut
    return [mod.maxcut_problem(mod.random_graph_weights(s, side))[0]
            for s in range(B)]


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def _polar_inputs(B, side, kind, seed):
    """B symmetric matrices: "random" or "deficient" (an even count of
    exactly-zero eigenvalues, about half the spectrum, so that the rank
    (side + tr sign) / 2 is not a tie at .5; a few large positive
    eigenvalues); instance 1 NaN."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, side, side))
    X = 0.5 * (X + X.transpose(0, 2, 1))
    if kind == "deficient":
        Q, _ = np.linalg.qr(rng.standard_normal((B, side, side)))
        w = rng.standard_normal((B, side))
        w[:, : 2 * (side // 4)] = 0.0
        w[:, -3:] = 20.0 + rng.random((B, 3))
        X = np.einsum("bik,bk,bjk->bij", Q, w, Q)
    X[1, 2, 5] = X[1, 5, 2] = np.nan
    return X


@pytest.mark.parametrize("kind", ["random", "deficient"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("side", [100, 130])
def test_polar_psd_batch_matches_jax(side, dtype, kind):
    """``polar_psd_batch`` against the vmapped JAX ``polar_psd`` (the
    default schedule, 7 quintic and 4 cubic steps): the projections within
    POLAR_RTOL of the largest entry, the ranks equal, the NaN instance
    passed through with rank = side."""
    X = _polar_inputs(3, side, kind, seed=side)
    opts = jx.Options()
    want_X, want_r = jax.vmap(lambda Xb: jcones.polar_psd(
        Xb, side, aggressive=opts.polar_aggressive,
        polish=opts.polar_polish))(jnp.asarray(X, dtype))
    got_X, got_r = tcones.polar_psd_batch(
        torch.tensor(X, dtype=getattr(torch, dtype)),
        aggressive=opts.polar_aggressive, polish=opts.polar_polish)
    want_X, got_X = np.asarray(want_X, np.float64), got_X.double().numpy()
    assert got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    assert int(got_r[1]) == side
    np.testing.assert_array_equal(np.isnan(got_X), np.isnan(X))
    ok = [0, 2]
    scale = np.abs(X[ok]).max()
    assert np.abs(got_X[ok] - want_X[ok]).max() <= POLAR_RTOL[dtype] * scale


def test_jax_f64_polar_products_are_f64():
    """``polar_psd`` wraps its products in default_matmul_precision(
    "float32"); on f64 operands XLA:CPU still multiplies in f64 (the
    products equal NumPy's f64 products to f64 rounding, far from an f32
    product's error), so the port's f64 polar runs K5's f64 products."""
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((2, 100, 100))
    with jax.default_matmul_precision("float32"):
        got = np.asarray(jnp.asarray(A) @ jnp.asarray(B))
    exact = A @ B
    assert np.abs(got - exact).max() <= 1e-13 * np.abs(exact).max()
    f32 = A.astype(np.float32) @ B.astype(np.float32)
    assert np.abs(f32 - exact).max() > 1e-8 * np.abs(exact).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_polar_kernels_plain_match_single(dtype):
    """The plain versions of K5b and K6b equal K5's and K6's, instance by
    instance (the same arithmetic, a leading instance axis)."""
    X = torch.tensor(_polar_inputs(3, 40, "random", seed=1), dtype=dtype)
    X[1] = 1.0  # finite
    C = X.flip(2).contiguous()
    got = kernels.ns_gemm_batch(X, C, X, 0.5, -1.5)
    Y = kernels.fro_scale_batch(X)
    S = kernels.sym_batch(C)
    Xp, rank, bad = kernels.sym_guard_batch(C, S, X)
    for z in range(3):
        torch.testing.assert_close(
            got[z], kernels.ns_gemm(X[z], C[z], X[z], 0.5, -1.5),
            rtol=0, atol=0)
        torch.testing.assert_close(Y[z], kernels.fro_scale(X[z])[0],
                                   rtol=0, atol=0)
        torch.testing.assert_close(S[z], kernels.sym(C[z]), rtol=0, atol=0)
        xp, r, b = kernels.sym_guard(C[z], S[z], X[z])
        torch.testing.assert_close(Xp[z], xp, rtol=0, atol=0)
        assert int(rank[z]) == int(r) and bool(bad[z]) == bool(b)
    assert sum(kernels.launch_counts.values()) == 0


def test_batched_polar_kernels_check_shapes():
    X = torch.zeros(2, 5, 5)
    with pytest.raises(ValueError, match="shapes"):
        kernels.ns_gemm_batch(X, torch.zeros(2, 4, 5))
    with pytest.raises(ValueError, match="3-d"):
        kernels.ns_gemm_batch(X[0], X[0])
    with pytest.raises(ValueError, match="want"):
        kernels.sym_guard_batch(X, X[:, :4, :4], X)


@pytest.mark.parametrize("side, kw", [(100, {"projection": "polar"}),
                                      (130, {})])
def test_f64_program_iterates_match_jax(side, kw):
    """The f64 program (hybrid_precision=False) from one stacked
    init_state: 50 iterations of B = 3 instances under the polar engine
    at side 100, 30 of B = 2 in the eigh mode at side 130 (the sides K9L
    takes on the card), every field within ITER_RTOL."""
    B, iters = (3, 50) if kw else (2, 30)
    opts_j = jbatch._force_batch_options(jx.Options(hybrid_precision=False,
                                                    **kw))
    opts_t = tbatch._force_batch_options(tx.Options(hybrid_precision=False,
                                                    **kw))
    assert tcones.projection_kind(side, opts_t, False) == (
        "polar" if kw else "full")
    setups_j = [jpreprocess(p) for p in _problems(jx, B, side)]
    layout = setups_j[0].layout
    ops_j, kind = jbatch._batch_operands(setups_j, jnp.float64)
    states_j = jbatch._stack_states(
        [jbatch.init_state(layout, opts_j, s) for s in setups_j])
    host = tp.jax_state_numpy(states_j)
    run_j, _ = jbatch._cached_batch_runner(layout, opts_j, kind)
    want = tp.jax_state_numpy(run_j(
        states_j, ops_j._replace(chunk_end=jnp.asarray(iters, jnp.int32))))
    setups_t = [preprocess(p) for p in _problems(tx, B, side)]
    ops_t = tbatch._batch_operands(setups_t, torch.float64, tp.DEV, "auto")
    run_t = tbatch.make_batch_runner(setups_t[0].layout, opts_t,
                                     device=tp.DEV)[0]
    got = convert.state_to_numpy(run_t(convert.state_from_numpy(host, tp.DEV),
                                       ops_t, iters))
    np.testing.assert_array_equal(got["iter"], np.full(B, iters))
    for name in want:
        if name in ("warm", "sub_stats", "sub_worst"):
            continue  # below
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            scale = max(np.abs(w[np.isfinite(w)]).max(initial=0.0), 1.0)
            np.testing.assert_allclose(g, w, rtol=ITER_RTOL,
                                       atol=ITER_RTOL * scale, err_msg=name)
    g, w = got["warm"][0], want["warm"][0]
    if kw:  # the polar engine keeps the warm vectors
        np.testing.assert_array_equal(g, host["warm"][0])
        np.testing.assert_array_equal(w, host["warm"][0])
    else:  # the top eigenvector, up to sign
        np.testing.assert_allclose(np.abs(np.sum(g * w, axis=1)), 1.0,
                                   rtol=0, atol=1e-9)


def _solve_both(B, side, mode="eigh", monkeypatch=None, **kw):
    """The JAX batch and the port's (on the CPU) on the same instances;
    with ``monkeypatch`` the JAX driver lined up with the port's subspace
    mode (C11, C12) and its reseeds and programs logged."""
    events = {"reseeds": [], "programs": [], "patched": False}
    if monkeypatch is not None:
        _jax_logged(monkeypatch, events)
    want = jbatch.solve_batch(_problems(jx, B, side), jx.Options(**kw),
                              projection=mode)
    stats = tbatch.BatchStats()
    got = tx.solve_batch(_problems(tx, B, side), tx.Options(**kw),
                         projection=mode, device="cpu", stats=stats)
    return want, got, events, stats


def test_polar_hybrid_solve_matches_jax():
    """Options(projection="polar") at side 100, B = 3, the default hybrid
    program: the f32 race and the f64 phase both on the polar engine, as
    in the JAX batch.  The same statuses (1) and iterations, objectives
    within OBJ_RTOL (here within 1e-7)."""
    want, got, _, stats = _solve_both(3, 100, projection="polar",
                                      tol_gap=1e-4, tol_feasibility=1e-4)
    assert stats.race_iters > 0
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert g.iter == w.iter
        assert _rel(g.objval, w.objval) <= OBJ_RTOL


def test_polar_below_min_side_is_the_eigh_mode():
    """Below polar_min_side (100) projection="polar" runs the dense eigh,
    in both packages: at side 40 the f64 program gives the eigh mode's
    answers, bit for bit in the port, to 1e-9 of the JAX package's."""
    kw = dict(hybrid_precision=False, tol_gap=1e-4, tol_feasibility=1e-4)
    assert tcones.projection_kind(40, tx.Options(projection="polar"),
                                  False) == "full"
    want, got, _, _ = _solve_both(2, 40, projection="polar", **kw)
    plain = tx.solve_batch(_problems(tx, 2, 40), tx.Options(**kw),
                           device="cpu")
    for g, w, e in zip(got, want, plain):
        assert g.status == w.status == 1 and g.iter == w.iter == e.iter
        assert g.objval == e.objval
        assert _rel(g.objval, w.objval) <= 1e-9


def test_subspace_mode_side130_matches_jax(monkeypatch):
    """The subspace mode's f64 program at side 130 (B = 3; on the card
    the bucket 24 of f64 takes K12, a bucket of 48 at k = 64 K12L), lined
    up with the JAX driver (C11, C12): the same reseed calls and programs
    (16, an escalation to 24 at iteration 128, back to 16), iterations and
    statuses, objectives within 1e-8 relative.  Instance 2 stalls in both
    packages (C13: its f64 subspace program loses the positive eigenspace
    between reseeds), so the run is cut at 1200 iterations: status 3 there
    (uncut, it parts from the JAX run after ~1500)."""
    want, got, events, stats = _solve_both(
        3, 130, mode="subspace", monkeypatch=monkeypatch,
        hybrid_precision=False, subspace_mixed=False, tol_gap=1e-4,
        tol_feasibility=1e-4, max_iter=1200)
    assert [(k, n, r) for _, _, _, k, n, r in stats.reseeds] \
        == events["reseeds"]
    assert [(d, k) for d, _, k in stats.programs] == events["programs"] == [
        ("float64", 16), ("float64", 24), ("float64", 16)]
    assert [r.iter for r in got] == [r.iter for r in want]
    assert [r.status for r in got] == [r.status for r in want] == [1, 1, 3]
    for g, w in zip(got, want):
        assert _rel(g.objval, w.objval) <= 1e-8


@pytest.mark.parametrize("kw", [
    {"equilibration": True}, {"block_equilibration": True},
    {"equilibration_force": True, "block_equilibration": True}])
def test_equilibration_options_ignored_as_in_jax(kw):
    """The batch drivers accept the equilibration options and do not
    equilibrate (JAX batch.py:257-269, 311-318): the f64 program's answers
    equal the JAX package's under the same options (1e-9) and the port's
    without them (bit for bit)."""
    base = dict(hybrid_precision=False, tol_gap=1e-4, tol_feasibility=1e-4)
    want, got, _, _ = _solve_both(3, 12, **base, **kw)
    plain = tx.solve_batch(_problems(tx, 3, 12), tx.Options(**base),
                           device="cpu")
    for g, w, e in zip(got, want, plain):
        assert g.status == w.status == 1 and g.iter == w.iter
        assert _rel(g.objval, w.objval) <= 1e-9
        np.testing.assert_array_equal(g.primal, e.primal)


@pytest.mark.parametrize("side, k, dtype, mixed, large, small_global", [
    (40, 16, torch.float32, False, False, False),
    (130, 48, torch.float64, False, True, False),
    (130, 64, torch.float64, False, True, False),
    (500, 24, torch.float32, False, False, False),
    (500, 32, torch.float32, False, True, False),
    (500, 16, torch.float64, True, False, False),
    (500, 24, torch.float64, True, True, False),
    (500, 96, torch.float64, False, True, False),
    (500, 128, torch.float64, False, True, True),
    (500, 128, torch.float32, False, True, False),
    (500, 192, torch.float64, True, True, True),
    (500, 256, torch.float32, False, True, True)])
def test_subspace_route_and_workspace(side, k, dtype, mixed, large,
                                      small_global):
    """K12 where its working set fits in a block's shared memory and k <=
    64, else K12L; K12L's workspace holds the s x k panels (and the k x k
    regions where they pass shared memory), in 256-byte steps."""
    t = torch.finfo(dtype).bits // 8
    c = 4 if mixed else t
    fits = kernels.subspace_smem_bytes(side, k, dtype, mixed) \
        <= kernels.SUBSPACE_SMEM_BYTES
    assert (k > kernels.SUBSPACE_MAX_K or not fits) == large
    stride, glob = kernels.subspace_large_bytes(side, k, dtype, mixed)
    assert glob == small_global and stride % 256 == 0
    panels = 2 * side * k * t + 2 * k * t + 2 * side * k * c
    assert panels <= stride < panels + 256 + (2 * (k + 1) ** 2 * c + 4 * k * c
                                              if glob else 0)
