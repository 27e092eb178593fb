"""Per-instance operators in the port's batch driver against the JAX
package's (``proxsdp_tpu.parallel.batch``, batch.py:219-270).

Where the instances of a sweep differ in [A; G] the JAX driver stacks
their operators -- "ell_batched" (one sparsity pattern, per-instance
values) or "dense_batched" (a (B, p+m, n) stack) -- and vmaps them.  The
port holds the same stacks (``ops.linop.EllOp`` with stacked values,
``DenseOp`` over (B, R, n)); here its operator kinds, its products and
its linesearch over them, and whole sweeps are held to the JAX package on
the CPU: randsdp (dense A_k, "dense_batched") and a max-cut whose
diagonal rows carry per-instance weights (one pattern, "ell_batched" in
the port; see ``chip_smoke.k3_problems``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
import chip_smoke
import proxsdp_tpu as jx
import proxsdp_tpu_torch as tx
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.models.randsdp import randsdp_problem as j_randsdp
from proxsdp_tpu.ops.linop import DenseOp as JDense, EllOp as JEll
from proxsdp_tpu.parallel import batch as jbatch
from proxsdp_tpu.problem import preprocess as jpreprocess
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch.models.randsdp import randsdp_problem as t_randsdp
from proxsdp_tpu_torch.parallel import batch as tbatch
from proxsdp_tpu_torch.problem import preprocess as tpreprocess

B = 4


def _randsdp(pkg, B=B, side=10, m=5):
    build = j_randsdp if pkg is jx else t_randsdp
    return [build(s, side, m, varbounds=False)[0] for s in range(B)]


def _scaled_maxcut(pkg, B=B, side=10):
    mod = tp.jmaxcut if pkg is jx else tp.tmaxcut
    return chip_smoke.k3_problems(pkg.Optimizer, mod.random_graph_weights,
                                  B, side)


FAMILIES = {"randsdp": _randsdp, "scaled_maxcut": _scaled_maxcut}


def _operands(family, dt=torch.float64, **kw):
    setups_j = [jpreprocess(p) for p in FAMILIES[family](jx, **kw)]
    setups_t = [tpreprocess(p) for p in FAMILIES[family](tx, **kw)]
    ops_j, kind = jbatch._batch_operands(setups_j, jnp.float64)
    ops_t = tbatch._batch_operands(setups_t, dt, tp.DEV, "auto")
    return setups_j, setups_t, ops_j, kind, ops_t


def test_m_kind_detection():
    """tests/test_parallel.py:173-190's cases: a max-cut sweep shares its
    operator, a randsdp sweep stacks dense matrices (side 10: rows of 55
    entries; at side 4 the port's ELL-first policy stacks ELL values,
    where the JAX CPU policy stacks dense ones); a one-pattern sweep
    stacks ELL values in the port (its ELL-first policy), and in the JAX
    package too once its CPU policy builds ELL (density < 0.02 on more than
    2^16 entries: side 60), and stacks dense matrices under
    ``linop="dense"`` as the JAX package does at side 10."""
    def kinds(problems_j, problems_t, linop="auto"):
        setups_j = [jpreprocess(p) for p in problems_j]
        setups_t = [tpreprocess(p) for p in problems_t]
        _, kind = jbatch._batch_operands(setups_j, jnp.float64)
        o = tbatch._batch_operands(setups_t, torch.float64, tp.DEV, linop)
        return kind, tbatch.operator_kind(o.M)

    def maxcut(pkg):
        mod = tp.jmaxcut if pkg is jx else tp.tmaxcut
        return [mod.maxcut_problem(mod.random_graph_weights(s, 8))[0]
                for s in range(3)]

    assert kinds(maxcut(jx), maxcut(tx)) == ("shared", "shared")
    assert kinds(_randsdp(jx, 3, 10, 3), _randsdp(tx, 3, 10, 3)) == (
        "dense_batched", "dense_batched")
    # side 4: each dense row holds 10 entries, within the port's ELL width
    assert kinds(_randsdp(jx, 3, 4, 3), _randsdp(tx, 3, 4, 3)) == (
        "dense_batched", "ell_batched")
    assert kinds(_scaled_maxcut(jx, 3, 60), _scaled_maxcut(tx, 3, 60)) == (
        "ell_batched", "ell_batched")
    assert kinds(_scaled_maxcut(jx, 3, 10), _scaled_maxcut(tx, 3, 10),
                 "dense") == ("dense_batched", "dense_batched")
    assert kinds(_scaled_maxcut(jx, 3, 10), _scaled_maxcut(tx, 3, 10))[1] \
        == "ell_batched"


def _jax_vmapped(op, kind, method, V):
    axes = JDense(0) if kind == "dense_batched" else JEll(None, 0, None, 0)
    return np.asarray(jax.vmap(lambda o, v: getattr(o, method)(v),
                               in_axes=(axes, 0))(op, jnp.asarray(V)))


@pytest.mark.parametrize("family,side", [("randsdp", 10),
                                         ("scaled_maxcut", 60)])
def test_stacked_products_match_jax(family, side):
    """M x and M' y of every instance (the port's K16 / K1b' plain
    versions) against the JAX package's vmapped DenseOp / EllOp products,
    within 1e-15 relative; and against each instance's own operator."""
    setups_j, setups_t, ops_j, kind, ops_t = _operands(family, side=side)
    assert tbatch.operator_kind(ops_t.M) == kind
    rows, n = ops_t.M.shape
    rng = np.random.default_rng(0)
    X, Y = rng.standard_normal((B, n)), rng.standard_normal((B, rows))
    for method, V, fn in (("matvec", X, ops_t.M.matvec_batch),
                          ("rmatvec", Y, ops_t.M.rmatvec_batch)):
        want = _jax_vmapped(ops_j.M, kind, method, V)
        got = fn(torch.tensor(V)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-15 * np.abs(want).max())
    for i, s in enumerate(setups_t):
        single = tbatch.build_linop(s.A, s.G, torch.float64, device=tp.DEV)
        np.testing.assert_allclose(
            ops_t.M.matvec_batch(torch.tensor(X))[i].numpy(),
            single.matvec(torch.tensor(X[i])).numpy(), rtol=1e-14, atol=1e-14)


def test_gemv_plain_versions_and_launch_counts():
    """K16's plain versions are each instance's product; on the CPU no
    kernel launches, and a stacked operator has no single products."""
    rng = np.random.default_rng(1)
    M = torch.tensor(rng.standard_normal((3, 5, 7)))
    x, y = torch.tensor(rng.standard_normal((3, 7))), torch.tensor(
        rng.standard_normal((3, 5)))
    kernels.reset_launch_counts()
    got, got_t = kernels.batched_gemv(M, x), kernels.batched_gemv_t(M, y)
    for i in range(3):
        torch.testing.assert_close(got[i], M[i] @ x[i], rtol=1e-15, atol=0)
        torch.testing.assert_close(got_t[i], M[i].T @ y[i], rtol=1e-15,
                                   atol=1e-15)
    assert not any(kernels.launch_counts.values())
    assert not any(kernels.per_instance_launches.values())
    with pytest.raises(ValueError):
        kernels.batched_gemv(M, y)
    op = tbatch.DenseOp(M)
    assert op.batched and op.shape == (5, 7)
    with pytest.raises(ValueError, match="per-instance"):
        op.matvec(x[0])


def _jax_state(stacked: dict):
    return jsolver.State(**{k: (tuple(jnp.asarray(w) for w in v)
                                if k == "warm" else jnp.asarray(v))
                            for k, v in stacked.items()})


@pytest.mark.parametrize("family,side", [("randsdp", 10),
                                         ("scaled_maxcut", 60)])
def test_linesearch_batch_plain_matches_jax(family, side):
    """``linesearch_loop_batch_plain`` over the per-instance M' (K15b''s
    plain version) against the JAX package's vmapped ``_linesearch``, from
    one random state whose steps take several trials: y, Mty, theta and
    the step within 1e-15 relative."""
    setups_j, setups_t, ops_j, kind, ops_t = _operands(family, side=side)
    layout = setups_j[0].layout
    opts_j = jbatch._force_batch_options(jx.Options(hybrid_precision=False))
    host = tp.jax_state_numpy(jbatch._stack_states(
        [jbatch.init_state(layout, opts_j, s) for s in setups_j]))
    rng = np.random.default_rng(2)
    rows = layout.p + layout.m
    for name, k in (("y", rows), ("y_old", rows), ("Mx", rows),
                    ("Mx_old", rows)):
        host[name] = rng.standard_normal((B, k))
    y_old = torch.tensor(host["y_old"])
    host["Mty_old"] = ops_t.M.rmatvec_batch(y_old).numpy()
    host["primal_step"] = rng.uniform(0.5, 4.0, B)
    host["primal_step_old"] = host["primal_step"].copy()
    host["theta"] = rng.uniform(0.5, 1.0, B)
    axes = JDense(0) if kind == "dense_batched" else JEll(None, 0, None, 0)
    op_axes = jsolver.Operands(M=axes, b=0, h=0, c=0, norm_b=0, norm_h=0,
                               norm_c=0, chunk_end=None, obj_scale=0,
                               row_unscale=None)
    want = jax.vmap(lambda s, o: jsolver._linesearch(s, o, layout, opts_j),
                    in_axes=(0, op_axes))(_jax_state(host), ops_j)
    s = convert.state_from_numpy(host, tp.DEV)
    y, Mty, theta, ps, trials = kernels.linesearch_loop_batch_plain(
        ops_t.M, s.y, s.Mx, s.Mx_old, ops_t.b, ops_t.h, s.y_old, s.Mty,
        s.Mty_old, s.primal_step, s.primal_step_old, s.theta, s.beta,
        torch.ones(B, dtype=torch.bool), layout.p, layout.m, opts_j.delta,
        opts_j.linsearch_decay, opts_j.max_linsearch_steps)
    assert int(trials.max()) > 1
    for got, w in ((y, want.y), (Mty, want.Mty), (theta, want.theta),
                   (ps, want.primal_step)):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-15 * np.abs(w).max())


@pytest.mark.parametrize("family", ["randsdp", "scaled_maxcut"])
def test_iterates_match_jax(family):
    """60 iterations of the f64 program (hybrid_precision=False) from one
    stacked init_state: every field within 1e-10 relative, iterations and
    statuses equal (randsdp: dense_batched in both; the scaled max-cut:
    ell_batched in the port, dense_batched in the JAX package at side
    10 -- one rule, two policies, the same iterates to rounding)."""
    opts_j = jbatch._force_batch_options(jx.Options(hybrid_precision=False))
    opts_t = tbatch._force_batch_options(tx.Options(hybrid_precision=False))
    setups_j, setups_t, ops_j, kind, ops_t = _operands(family)
    layout = setups_j[0].layout
    states_j = jbatch._stack_states(
        [jbatch.init_state(layout, opts_j, s) for s in setups_j])
    host = tp.jax_state_numpy(states_j)
    run_j, _ = jbatch._cached_batch_runner(layout, opts_j, kind)
    want = tp.jax_state_numpy(run_j(
        states_j, ops_j._replace(chunk_end=jnp.asarray(60, jnp.int32))))
    run_t = tbatch.make_batch_runner(setups_t[0].layout, opts_t,
                                     device=tp.DEV)[0]
    got = convert.state_to_numpy(run_t(convert.state_from_numpy(host, tp.DEV),
                                       ops_t, 60))
    np.testing.assert_array_equal(got["iter"], np.full(B, 60))
    for name in want:
        if name == "warm":  # an eigenvector: compared up to sign
            g, w = got[name][0], want[name][0]
            np.testing.assert_allclose(np.abs(np.sum(g * w, axis=1)), 1.0,
                                       rtol=0, atol=1e-8)
            continue
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-10 * max(np.abs(w).max(), 1e-300),
                                       err_msg=name)


@pytest.mark.parametrize("family", ["randsdp", "scaled_maxcut"])
def test_default_solve_matches_jax(family):
    """The default Options() sweep (f32 race, hand-over with the operands
    rebuilt in f64, f64 phase) at 1e-4 tolerances, projection pinned to
    "eigh": every status 1 as in the JAX package, each objective within
    2e-4 (1 + |obj|) of its; the f32 race sums in other orders."""
    opts = dict(tol_gap=1e-4, tol_feasibility=1e-4)
    want = jbatch.solve_batch(FAMILIES[family](jx), jx.Options(**opts),
                              projection="eigh")
    stats = tbatch.BatchStats()
    got = tx.solve_batch(FAMILIES[family](tx), tx.Options(**opts),
                         projection="eigh", device=tp.DEV, stats=stats)
    assert stats.race_iters > 0
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert abs(g.objval - w.objval) <= 2e-4 * (1 + abs(w.objval)), (
            g.objval, w.objval)


def test_subspace_reseed_reads_each_instance_mty():
    """The subspace mode's host reseed builds each instance's
    pre-projection matrix from its own Mty (batch.py:69-120): with
    per-instance operators the instances' M'y differ, and the reseeded
    basis of instance i is the top eigenvectors of x_i - tau_i (Mty_i +
    c_i)."""
    side = 40
    probs = _scaled_maxcut(tx, B, side)
    setups = [tpreprocess(p) for p in probs]
    layout = setups[0].layout
    opts = tbatch._force_batch_options(tx.Options(hybrid_precision=False)
                                       ).replace(subspace_rank=16,
                                                 subspace_accept_always=True)
    o = tbatch._batch_operands(setups, torch.float64, tp.DEV, "auto")
    assert tbatch.operator_kind(o.M) == "ell_batched"
    s = tbatch._stack_states(layout, opts, setups, tp.DEV)
    rng = np.random.default_rng(3)
    y = torch.tensor(rng.standard_normal((B, layout.p + layout.m)))
    s = s.replace(x=torch.tensor(rng.standard_normal((B, layout.n))),
                  Mty=o.M.rmatvec_batch(y))
    c_np = np.stack([np.asarray(st.c, np.float64) for st in setups])
    s2, _ = tbatch._reseed_batch(s, layout, 16, np.ones(B, bool), c_np, opts)
    gidx, in_scale, _, _ = kernels._maps(side)
    for i in range(B):
        pre = (s.x[i].numpy() - s.primal_step[i].item()
               * (s.Mty[i].numpy() + c_np[i]))
        w, V = np.linalg.eigh((pre[gidx] * in_scale).reshape(side, side))
        np.testing.assert_allclose(np.abs(np.sum(
            s2.warm[0][i].numpy() * V[:, -16:][:, ::-1], axis=0)), 1.0,
            atol=1e-8)
    assert not torch.equal(s.Mty[0], s.Mty[1])
