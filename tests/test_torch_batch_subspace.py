"""The batch driver's subspace mode (``projection="subspace"``, or "auto"
at B > 32) in the port against the JAX package, on the CPU.

B = 4-8 max-cut instances of side 36-50, one torch thread
(``_torch_parity``).  The same inputs, made with numpy from a seed, go
through the JAX function and the port's plain version: the accept-always
subspace step (K12's plain version) against the vmapped JAX step, the host
reseed bit for bit, the f64 program's reseed decisions, iterations and
objectives, the bucket escalation and the drop to the eigh program, the
default hybrid run, the "auto" gate, and K9's plain version at side 100.

The JAX step turns an exactly-zero X V (the cold start's first
projection) into a zero basis, which only XLA's rounding noise on that 0
brings back; the port keeps the old basis there (ROADMAP C11).  Driver
comparisons therefore give the JAX run, after its first iteration, the
basis the port's first iteration computes (``_jax_logged``), as the
Lanczos parity tests do for C10.
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

TOL_PSD = 1e-7
# the step against JAX's: f64 the same arithmetic up to summation order
# and LAPACK builds; mixed and f32 build the basis in f32 (f32 products
# summed in other orders, Ritz vectors to ~1e-6), relative to the block's
# largest entry
STEP_TOL = {"f64": 1e-12, "mixed": 1e-4, "f32": 1e-4}
# the hybrid mode's objectives against the JAX run lined up with the port
# (C11, C12), each and on average, relative to 1 + |obj|: chip_smoke.py's
# phase G bounds, set from the reference's own 1- and 8-thread scatter and
# the port's runs (PERF.md)
OBJ_RTOL, OBJ_MEAN_RTOL = 1.5e-3, 2e-4


def _problems(pkg, B, side):
    mod = tp.jmaxcut if pkg is jx else tp.tmaxcut
    return [mod.maxcut_problem(mod.random_graph_weights(s, side))[0]
            for s in range(B)]


def _rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


def _step_inputs(B, side, k, seed=0):
    """B packed blocks with six clear positive eigenvalues and orthonormal
    (side, k) bases; instance 1 has a NaN entry."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((B, side, side)))
    w = rng.standard_normal((B, side))
    w[:, :6] = 5.0 + 3.0 * rng.random((B, 6))
    X = np.einsum("bik,bk,bjk->bij", Q, w, Q)
    V, _ = np.linalg.qr(rng.standard_normal((B, side, k)))
    v = kernels.square_to_tri_plain(torch.tensor(X), side).numpy()
    v[1, 3] = np.nan
    return v, V


def _jax_step(v, V, side, mode):
    dt = np.float32 if mode == "f32" else np.float64
    opts = jx.Options(subspace_rank=V.shape[2], subspace_accept_always=True,
                      subspace_mixed=mode == "mixed",
                      dtype="float32" if mode == "f32" else "float64")
    step = jax.jit(jax.vmap(lambda vb, wb: jcones.psd_projection_block(
        vb, side, jnp.int32(2), wb, opt=opts, allow_lanczos=True)))
    r = step(jnp.asarray(v, dt), jnp.asarray(V, dt))
    return (np.asarray(r.block), np.asarray(r.min_eig),
            np.asarray(r.current_rank), np.asarray(r.warm),
            np.asarray(r.used_full), np.asarray(r.sub_stats))


@pytest.mark.parametrize("mode", ["f64", "mixed", "f32"])
def test_subspace_step_matches_jax(mode):
    """The accept-always step (cones.py:427-510, vmapped) on 6 instances of
    side 40 at k = 16, one of them non-finite: the projected blocks, min
    eigenvalue, rank, NaN guard and sub_stats within STEP_TOL; the new
    bases up to column sign where the Ritz value is simple; the guarded
    instance keeps its block and basis."""
    side, k = 40, 16
    v, V = _step_inputs(6, side, k)
    dt = np.float32 if mode == "f32" else np.float64
    want = _jax_step(v, V, side, mode)
    got = [t.numpy() for t in kernels.batched_subspace_plain(
        torch.tensor(v.astype(dt)), torch.tensor(V.astype(dt)), side, TOL_PSD,
        mode == "mixed")]
    blk, me, rank, warm, bad, stats = got
    jblk, jme, jrank, jwarm, jbad, jstats = want
    tol = STEP_TOL[mode]
    scale = np.nanmax(np.abs(v))
    np.testing.assert_array_equal(bad, jbad)
    assert bad.tolist() == [False, True, False, False, False, False]
    np.testing.assert_array_equal(np.isnan(blk), np.isnan(jblk))
    np.testing.assert_allclose(blk, jblk, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(me, jme, rtol=0, atol=tol * scale)
    np.testing.assert_array_equal(rank, jrank)
    np.testing.assert_array_equal(stats[:, 2], jstats[:, 2])
    np.testing.assert_allclose(stats[:, :2], jstats[:, :2], rtol=0,
                               atol=tol * scale)
    # the guarded instance: its basis back unchanged
    np.testing.assert_array_equal(warm[1], V[1].astype(dt))
    np.testing.assert_array_equal(jwarm[1], V[1].astype(dt))
    # Ritz vectors up to sign, where the Ritz value is simple
    th = np.linalg.eigvalsh(np.einsum(
        "bik,bij,bjl->bkl", jwarm, kernels.tri_to_square_plain(
            torch.tensor(np.nan_to_num(v)), side).numpy(), jwarm))[:, ::-1]
    for b in (0, 2, 3, 4, 5):
        gaps = np.minimum(np.abs(np.diff(th[b], prepend=np.inf)),
                          np.abs(np.diff(th[b], append=-np.inf)))
        simple = gaps > 1e-3 * scale
        dots = np.abs(np.sum(warm[b] * jwarm[b], axis=0))[simple]
        np.testing.assert_allclose(dots, 1.0, rtol=0, atol=max(tol, 1e-10))


# the mixed mode's f64 Rayleigh quotients on bases spanning the top
# eigenvectors: second order in the f32 basis' rounding (~1e-10 of the
# largest entry), while an f32 eigh's Ritz values lie ~1e-6 to 1e-5 away
THETA_TOL = 1e-8


def _thetas(out, side):
    """Ritz values of a step's output in f64: theta_j of each positive pair
    as w_j^T Xp w_j / |w_j|^4 from the blocks and the basis, min_eig and
    stats' min theta."""
    blk, me, _, warm, _, stats = (np.asarray(a, np.float64) for a in out)
    Xp = kernels.tri_to_square_plain(torch.tensor(blk), side).numpy()
    th = np.einsum("bik,bij,bjk->bk", warm, Xp, warm) \
        / np.sum(warm * warm, axis=1) ** 2
    return th, me, stats[:, 1]


@pytest.mark.parametrize("side, k", [(40, 16), (100, 16), (100, 24)])
def test_mixed_step_rayleigh_quotients_match_jax(side, k):
    """The mixed mode (subspace_mixed) takes its Ritz values as f64 Rayleigh
    quotients (cones.py:435-441): on bases that span the top eigenvectors
    they agree with the JAX step's to THETA_TOL of the largest entry,
    while the f32 mode on the same inputs -- Ritz values and XW in f32 --
    lies outside that bound."""
    rng = np.random.default_rng(side + k)
    Q, _ = np.linalg.qr(rng.standard_normal((6, side, side)))
    w = rng.standard_normal((6, side))
    w[:, :6] = 5.0 + 3.0 * rng.random((6, 6))
    X = np.einsum("bik,bk,bjk->bij", Q, w, Q)
    top = np.argsort(-w, axis=1)[:, :k]
    V = np.take_along_axis(Q, top[:, None, :], axis=2) @ np.linalg.qr(
        rng.standard_normal((6, k, k)))[0]
    v = kernels.square_to_tri_plain(torch.tensor(X), side).numpy()
    scale = np.abs(v).max()
    want = _thetas(_jax_step(v, V, side, "mixed"), side)
    got = _thetas([t.numpy() for t in kernels.batched_subspace_plain(
        torch.tensor(v), torch.tensor(V), side, TOL_PSD, True)], side)
    ctl = _thetas([t.numpy() for t in kernels.batched_subspace_plain(
        torch.tensor(v).float(), torch.tensor(V).float(), side, TOL_PSD,
        False)], side)
    err = max(np.abs(a - b).max() for a, b in zip(got, want)) / scale
    err_ctl = max(np.abs(a - b).max() for a, b in zip(ctl, want)) / scale
    assert err <= THETA_TOL < err_ctl


def test_subspace_step_zero_matrix_keeps_basis():
    """X V exactly 0 (a cold start's first projection): the step
    orthonormalises the old basis instead of zeroing it (ROADMAP C11);
    the projection is 0, every Ritz value 0, no guard."""
    side, k = 40, 16
    _, V = _step_inputs(2, side, k)
    v = torch.zeros((2, side * (side + 1) // 2), dtype=torch.float64)
    blk, me, rank, warm, bad, stats = kernels.batched_subspace_plain(
        v, torch.tensor(V), side, TOL_PSD, False)
    eps = kernels.CHOLQR_EPS[torch.float64]
    Q = kernels._cholqr_batch_plain(
        kernels._cholqr_batch_plain(torch.tensor(V), eps), eps)
    assert not bad.any() and (blk == 0).all() and (rank == 0).all()
    assert (me == 0).all() and (stats == 0).all()
    np.testing.assert_allclose(np.abs(np.sum(warm.numpy() * Q.flip(-1).numpy(),
                                             axis=1)), 1.0, atol=1e-12)


def _states_after(pkg, B, side, k, iters, dtype):
    """Both packages' batched states after ``iters`` iterations of the
    JAX subspace program from one stacked init_state (the JAX iterate is
    handed over, so the two hold the same arrays)."""
    opts = jbatch._force_batch_options(jx.Options(
        hybrid_precision=False, dtype=dtype)).replace(
            subspace_rank=k, subspace_accept_always=True)
    setups = [jpreprocess(p) for p in _problems(jx, B, side)]
    layout = setups[0].layout
    dt = jnp.float32 if dtype == "float32" else jnp.float64
    ops, kind = jbatch._batch_operands(setups, dt)
    states = jbatch._stack_states(
        [jbatch.init_state(layout, opts, s) for s in setups])
    run, _ = jbatch._cached_batch_runner(layout, opts, kind)
    states = run(states, ops._replace(chunk_end=jnp.asarray(iters, jnp.int32)))
    c_np = np.stack([s.c for s in setups])
    return states, layout, c_np, opts


@pytest.mark.parametrize("dtype, side, k_new", [
    ("float64", 40, 16), ("float32", 40, 16), ("float64", 50, 24)])
def test_reseed_batch_matches_jax(dtype, side, k_new):
    """_reseed_batch on one state: the same bases bit for bit, the same
    sub_worst resets and r_max, for a partial mask at the program's k and,
    at k_new != 16 (a bucket escalation), the rebuild of every basis.  The
    port's stacked eigh over the masked instances equals the JAX loop."""
    B = 6
    states, layout, c_np, opts = _states_after(jx, B, side, 16, 40, dtype)
    states = states._replace(sub_worst=jnp.asarray(
        np.linspace(0.0, 1e-6, B), states.sub_worst.dtype))
    tstates = convert.state_from_numpy(tp.jax_state_numpy(states), tp.DEV)
    mask = np.array([True, False, True, True, False, True])
    for k in (16, k_new):
        want, r_want = jbatch._reseed_batch(states, layout, k, mask, c_np,
                                            opts)
        got, r_got = tbatch._reseed_batch(tstates, layout, k, mask, c_np,
                                          opts)
        assert r_got == r_want > 0
        assert got.warm[0].dtype == tstates.x.dtype
        np.testing.assert_array_equal(got.warm[0].numpy(),
                                      np.asarray(want.warm[0]))
        np.testing.assert_array_equal(got.sub_worst.numpy(),
                                      np.asarray(want.sub_worst))


def _fetch_latest(ss):
    """The JAX batch runner's ``fetch`` (batch.py:159-176) reading each
    instance's ring buffers at its latest slot, (iter - 1) % L with L the
    ring length, as the port does (ROADMAP C12: the JAX fetch takes L from
    the batched buffers' leading axis, B)."""
    i = (ss.iter - 1) % ss.buf_gap.shape[1]
    take = jax.vmap(lambda buf, j: buf[j])
    ft = ss.buf_gap.dtype
    return jnp.stack([ss.iter.astype(ft), ss.status.astype(ft),
                      take(ss.buf_gap, i), take(ss.buf_feas, i),
                      take(ss.buf_prim_obj, i), take(ss.buf_dual_obj, i),
                      ss.sub_worst.astype(ft)], axis=-1)


def _jax_logged(monkeypatch, events):
    """Log the JAX driver's reseeds (k, instances masked, r_max) and
    programs (dtype, k); give its first subspace program, after iteration
    1, the basis the port's iteration 1 computes on X = 0 for each
    subspace block: cholqr2 of the start basis, its columns reversed
    (ROADMAP C11); and read its fetch at the latest ring slot (C12)."""
    reseed, runner = jbatch._reseed_batch, jbatch._cached_batch_runner

    def logged_reseed(states, layout, k, mask, c_np, opts):
        out, r = reseed(states, layout, k, mask, c_np, opts)
        events["reseeds"].append((int(k), int(np.sum(mask)), int(r)))
        return out, r

    def logged_runner(layout, opts, m_kind="shared"):
        events["programs"].append((opts.dtype, int(opts.subspace_rank)))
        run, _ = runner(layout, opts, m_kind)

        def run_patched(states, ops):
            if not events["patched"] and any(w.ndim == 3 for w in states.warm):
                events["patched"] = True
                starts = [np.asarray(w) for w in states.warm]
                states = run(states,
                             ops._replace(chunk_end=jnp.asarray(1, jnp.int32)))
                warm = list(states.warm)
                for bi, V in enumerate(starts):
                    if V.ndim == 3:
                        V = torch.tensor(V)
                        eps = kernels.CHOLQR_EPS[V.dtype]
                        Q = kernels._cholqr_batch_plain(
                            kernels._cholqr_batch_plain(V, eps), eps)
                        warm[bi] = jnp.asarray(Q.flip(-1).numpy())
                states = states._replace(warm=tuple(warm))
            return run(states, ops)

        return run_patched, jax.jit(_fetch_latest)

    monkeypatch.setattr(jbatch, "_reseed_batch", logged_reseed)
    monkeypatch.setattr(jbatch, "_cached_batch_runner", logged_runner)


def _both(monkeypatch, B, side, projection="subspace", **kw):
    events = {"reseeds": [], "programs": [], "patched": False}
    _jax_logged(monkeypatch, events)
    want = jbatch.solve_batch(_problems(jx, B, side), jx.Options(**kw),
                              projection=projection)
    stats = tbatch.BatchStats()
    got = tx.solve_batch(_problems(tx, B, side), tx.Options(**kw),
                         projection=projection, device="cpu", stats=stats)
    return want, got, events, stats


F64 = dict(hybrid_precision=False, subspace_mixed=False, tol_gap=1e-4,
           tol_feasibility=1e-4)


@pytest.mark.parametrize("case, side, kw, programs", [
    # one reseed at iteration 128 (r_max 6), bucket 16 throughout
    ("plain", 40, {}, [16]),
    # guard 13: bucket(6 + 13) = 24 is not below 40 // 2: the eigh program
    ("drop", 40, {"polish_subspace_guard": 13}, [16, 0]),
    # guard 12 at side 50: the bucket escalates to 24 < 25 at iteration
    # 128; instance 1's run is cut at 1300 iterations (status 3 in both
    # packages), after its reseed at 1152
    ("escalate", 50, {"polish_subspace_guard": 12, "max_iter": 1300},
     [16, 24]),
])
def test_f64_subspace_driver_matches_jax(monkeypatch, case, side, kw,
                                         programs):
    """The f64 program (hybrid_precision=False) in the subspace mode
    repeats the JAX batch driver: the same reseed calls (k, instances
    masked, r_max), program switches, iterations and statuses, objectives
    within 1e-8 relative."""
    want, got, events, stats = _both(monkeypatch, 4, side, **F64, **kw)
    assert [(k, n, r) for _, _, _, k, n, r in stats.reseeds] \
        == events["reseeds"]
    assert [(d, k) for d, _, k in stats.programs] == events["programs"]
    assert [k for _, _, k in stats.programs][:len(programs)] == programs
    assert [r.iter for r in got] == [r.iter for r in want]
    assert [r.status for r in got] == [r.status for r in want]
    for g, w in zip(got, want):
        assert _rel(g.objval, w.objval) <= 1e-8


def test_mixed_f64_subspace_driver_near_jax(monkeypatch):
    """The default f64 subspace program (subspace_mixed: an f32 basis):
    the same reseed calls, statuses 1, iterations within 5 % and
    objectives within 2e-4 (1 + |obj|) -- f32 products summed in other
    orders than XLA's move the trajectories slightly."""
    want, got, events, stats = _both(
        monkeypatch, 4, 40, hybrid_precision=False, tol_gap=1e-4,
        tol_feasibility=1e-4)
    assert [(k, n, r) for _, _, _, k, n, r in stats.reseeds] \
        == events["reseeds"]
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert abs(g.iter - w.iter) <= 0.05 * w.iter
        assert _rel(g.objval, w.objval) <= 2e-4


def test_hybrid_subspace_matches_jax(monkeypatch):
    """The default hybrid Options() in the subspace mode, on phase G's
    path: the f32 race on the f32 step, a host reseed at iteration 128
    whose rank outgrows side // 2 (guard 13 here: bucket(6 + 13) = 24),
    the drop to the f32 eigh program, the f64 eigh phase.  The same reseed
    calls and programs as the JAX driver (lined up for C11 and C12),
    statuses 1, iterations within 5 %, objectives within OBJ_RTOL each
    and OBJ_MEAN_RTOL on average: f32 races summed in other orders stop
    at other points of the 1e-4 tolerance box, which is ~1e-3 wide in the
    objective (here instance 3 ends 7.7e-4 from the JAX answer, the
    others within 6e-5)."""
    want, got, events, stats = _both(monkeypatch, 8, 40, tol_gap=1e-4,
                                     tol_feasibility=1e-4,
                                     polish_subspace_guard=13)
    assert [(k, n, r) for _, _, _, k, n, r in stats.reseeds] \
        == events["reseeds"] == [(16, 8, 6)]
    assert [(d, k) for d, _, k in stats.programs] == events["programs"] == [
        ("float32", 16), ("float32", 0), ("float64", 0)]
    dev = np.array([_rel(g.objval, w.objval) for g, w in zip(got, want)])
    assert dev.max() <= OBJ_RTOL and dev.mean() <= OBJ_MEAN_RTOL
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert abs(g.iter - w.iter) <= 0.05 * w.iter


@pytest.mark.parametrize("B, side, projection, sub", [
    (4, 40, "auto", False), (33, 10, "auto", False), (4, 40, "eigh", False),
    (4, 36, "subspace", True), (4, 33, "subspace", False)])
def test_projection_gate(B, side, projection, sub):
    """"auto" turns the subspace mode on only for B > 32 with a side that
    has 16 < side // 2; "subspace" at any B with such a side; "eigh"
    never (batch.py:336-345).  Checked on the program's first steps."""
    stats = tbatch.BatchStats()
    tx.solve_batch(_problems(tx, B, side), tx.Options(max_iter=2),
                   projection=projection, device="cpu", stats=stats)
    assert stats.programs[0] == ("float32", 0, 16 if sub else 0)


def test_unknown_projection_raises():
    with pytest.raises(ValueError, match="unknown projection"):
        tx.solve_batch(_problems(tx, 2, 10), projection="dense", device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batched_eigh_plain_side100_matches_jax(dtype):
    """K9's plain version at side 100 (the eigh program after G2's drop)
    against the JAX batched projection (cones.py:622-675): blocks, ranks
    and warm vectors (up to sign) within 1e-10 / 1e-4 of the scale."""
    side, B = 100, 4
    dt = np.float32 if dtype == "float32" else np.float64
    rng = np.random.default_rng(3)
    X = rng.standard_normal((B, side, side))
    X = 0.5 * (X + X.transpose(0, 2, 1))
    v = kernels.square_to_tri_plain(torch.tensor(X), side).numpy().astype(dt)
    opts_j = jx.Options(dtype=dtype)
    jb, jme, jcur, jwarm = (np.asarray(a) for a in
                            jcones.psd_projection_small_batch(
                                jnp.asarray(v), side, opt=opts_j))
    tb_, tme, tcur, twarm = (t.numpy() for t in
                             tcones.psd_projection_small_batch(
                                 torch.tensor(v), side,
                                 opts=tx.Options(dtype=dtype)))
    tol = 1e-10 if dtype == "float64" else 1e-4
    scale = np.abs(v).max()
    np.testing.assert_allclose(tb_, jb, rtol=0, atol=tol * scale)
    np.testing.assert_array_equal(tme, jme)
    np.testing.assert_array_equal(tcur, jcur)
    np.testing.assert_allclose(np.abs(np.sum(twarm * jwarm, axis=1)), 1.0,
                               atol=tol)


def test_subspace_state_round_trip():
    """A batched subspace state ((B, side, k) warm bases) goes from the
    JAX package to the port and back unchanged, both dtypes."""
    for dtype in ("float64", "float32"):
        states, *_ = _states_after(jx, 3, 40, 16, 3, dtype)
        host = tp.jax_state_numpy(states)
        back = convert.state_to_numpy(convert.state_from_numpy(host, tp.DEV))
        assert back["warm"][0].shape == (3, 40, 16)
        for name, v in host.items():
            for g, w in zip(back[name] if name == "warm" else [back[name]],
                            v if name == "warm" else [v]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_subspace_init_basis_matches_jax():
    """init_state draws the JAX package's random orthonormal start bases."""
    opts_j = jx.Options(subspace_rank=16)
    opts_t = tx.Options(subspace_rank=16)
    sj = jpreprocess(_problems(jx, 1, 40)[0])
    st = preprocess(_problems(tx, 1, 40)[0])
    want = jbatch.init_state(sj.layout, opts_j, sj).warm[0]
    got = tbatch.init_state(st.layout, opts_t, st)["warm"][0]
    assert got.shape == (40, 16)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("side, k, dtype, mixed, fits", [
    (40, 16, torch.float32, False, True), (100, 24, torch.float64, True, True),
    (100, 48, torch.float64, False, True), (118, 48, torch.float64, False, True),
    (130, 64, torch.float64, False, False), (190, 64, torch.float32, False, True)])
def test_subspace_smem_limit(side, k, dtype, mixed, fits):
    """K12's working set against one block's shared memory: every bucket
    the driver reaches below side 120 fits, k = 64 in f64 (side >= 130)
    does not (the wrapper runs K12L there:
    tests/test_torch_batch_large.py::test_subspace_route_and_workspace)."""
    need = kernels.subspace_smem_bytes(side, k, dtype, mixed)
    assert (need <= kernels.SUBSPACE_SMEM_BYTES) == fits


def test_batched_subspace_wrapper_checks():
    """The wrapper's argument checks (the CPU path then runs the plain
    version, the card the kernel)."""
    v, V = _step_inputs(2, 40, 16)
    with pytest.raises(ValueError, match="warm must be"):
        kernels.batched_subspace(torch.tensor(v), torch.tensor(V[:, :39]), 40,
                                 TOL_PSD)
    with pytest.raises(TypeError, match="mixed mode"):
        kernels.batched_subspace(torch.tensor(v, dtype=torch.float32),
                                 torch.tensor(V, dtype=torch.float32), 40,
                                 TOL_PSD, mixed=True)
    out = kernels.batched_subspace(torch.tensor(v), torch.tensor(V), 40,
                                   TOL_PSD)
    ref = kernels.batched_subspace_plain(torch.tensor(v),
                                              torch.tensor(V), 40, TOL_PSD,
                                              False)
    for a, b in zip(out, ref):
        assert torch.equal(torch.nan_to_num(a.double(), nan=7.0),
                           torch.nan_to_num(b.double(), nan=7.0))
    assert kernels.launch_counts["batched_subspace_f64"] == 0
