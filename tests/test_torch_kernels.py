"""The port's kernel wrappers on the CPU against the JAX package's code.

On a CPU tensor each wrapper runs its plain PyTorch version (the CUDA
kernels are checked against these same plain versions on the card by
chip_smoke.py).  Here each is held to the JAX expression it replaces:
elementwise results at rtol 1e-14 (same operations, same order) and
reductions at rtol 1e-12 (another summation order over <= 2,500 terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from proxsdp_tpu import solver as jsolver
from proxsdp_tpu.ops import cones as jcones
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver

F64 = torch.float64


def t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("p, m", [(6, 0), (4, 5)])
def test_ls_dual_update_matches_jax_linesearch_body(p, m):
    rng = np.random.RandomState(p + m)
    y, Mx, Mx_old, y_old = (rng.randn(p + m) for _ in range(4))
    b, h = rng.randn(p), rng.randn(m)
    ps, ps_old, beta = 0.31, 0.27, 1.7
    # solver.py:453-457 and cones.py:26-40
    theta = ps / ps_old
    bp = beta * ps
    y_half = jnp.asarray(y) + bp * ((1.0 + theta) * jnp.asarray(Mx) - theta * jnp.asarray(Mx_old))
    y_proj = jcones.box_projection(y_half, jnp.asarray(b), jnp.asarray(h), bp, p, m)
    want = np.asarray(y_half - bp * y_proj)
    got, sq = kernels.ls_dual_update(
        t(y), t(Mx), t(Mx_old), t(b), t(h), t(y_old),
        t(beta) * t(ps), t(ps) / t(ps_old), p, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(float(sq), np.sum((want - y_old) ** 2), rtol=1e-12)


def test_sq_dist():
    rng = np.random.RandomState(0)
    a, b = rng.randn(2500), rng.randn(2500)
    np.testing.assert_allclose(float(kernels.sq_dist(t(a), t(b))),
                               float(jnp.sum((jnp.asarray(a) - jnp.asarray(b)) ** 2)),
                               rtol=1e-12)


@pytest.mark.parametrize("side, n_free", [(5, 0), (4, 9)])
def test_primal_update_sym_matches_jax(side, n_free):
    n = side * side + n_free
    rng = np.random.RandomState(n)
    x, Mty, c = rng.randn(n), rng.randn(n), rng.randn(n)
    ps = 0.43
    u = jnp.asarray(x) - ps * (jnp.asarray(Mty) + jnp.asarray(c))  # solver.py:308
    X = u[: side * side].reshape(side, side)
    want = np.asarray(u).copy()
    want[: side * side] = np.asarray(0.5 * (X + X.T)).reshape(-1)  # cones.py:173
    got = kernels.primal_update_sym(t(x), t(Mty), t(c), t(ps), (side,))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)


def test_residuals_reductions_with_inequalities():
    """All nine slots, with equality and inequality rows and free entries
    after the block, against a NumPy transcription of solver.py:545-606."""
    side, n_free, p, m = 4, 9, 3, 4
    n = side * side + n_free
    rng = np.random.RandomState(5)
    x, x_old, Mty, Mty_old, c = (rng.randn(n) for _ in range(5))
    y, y_old, Mx, Mx_old = (rng.randn(p + m) for _ in range(4))
    b, h = rng.randn(p), rng.randn(m)
    tau, sigma = 0.3, 0.6
    w = np.ones(n)
    I, J = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    w[: side * side][(I != J).reshape(-1)] = np.sqrt(2.0)
    px_old, px = x_old - tau * Mty_old, x - tau * Mty
    py_old, py = y_old - sigma * Mx_old, y - sigma * Mx
    want = [np.max(np.abs((px - px_old) * w)), np.max(np.abs(px_old * w)),
            np.max(np.abs(py - py_old)), np.max(np.abs(py_old)),
            np.max(np.abs(Mx[:p] - b)), np.max(Mx[p:] - h),
            c @ x, b @ y[:p], h @ y[p:]]
    got = kernels.residuals(t(x), t(x_old), t(Mty), t(Mty_old), t(tau), t(y),
                            t(y_old), t(Mx), t(Mx_old), t(sigma), t(b), t(h),
                            t(c), p, m, (side,))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("name", ["maxcut50", "maxcut30"])
def test_residuals_and_gap_matches_jax(name):
    """The port's _residuals_and_gap (kernel K3 + its scalar formulas and
    ring writes) against the JAX function on one random state."""
    setup = tp.jax_setup(name)
    layout, opts = setup.layout, tp.jax_opts()
    host = tp.jax_state_numpy(jsolver.init_state(layout, opts, setup))
    rng = np.random.RandomState(9)
    for f in ("x", "x_old", "y", "y_old", "Mx", "Mx_old", "Mty", "Mty_old"):
        host[f] = rng.randn(*host[f].shape)
    host.update(primal_step=np.float64(0.8), dual_step=np.float64(0.3),
                iter=np.int32(7))
    o_j = tp.jax_operands(setup)
    want = jsolver._residuals_and_gap(
        jsolver.State(**{k: jnp.asarray(v) if k != "warm" else v
                         for k, v in host.items()}), o_j, layout, opts)
    got = tsolver._residuals_and_gap(
        convert.state_from_numpy(host, "cpu"),
        tp.torch_operands_from_jax(o_j, setup), layout, tp.torch_opts())
    tp.assert_states_close(convert.state_to_numpy(got),
                           tp.jax_state_numpy(want), rtol=1e-12, atol=1e-15)


def test_wrappers_reject_what_kernels_do_not_take():
    a = torch.zeros(8, dtype=F64)
    with pytest.raises(TypeError):
        kernels.sq_dist(a, torch.zeros(8, dtype=torch.float32))
    with pytest.raises(ValueError, match="non-contiguous"):
        kernels.sq_dist(torch.zeros(16, dtype=F64)[::2], a)
    with pytest.raises(ValueError, match="not supported"):  # no fallback
        kernels.sq_dist(torch.zeros(8, dtype=F64, device="meta"),
                        torch.zeros(8, dtype=F64, device="meta"))
    with pytest.raises(ValueError, match="int32"):
        kernels.ell_spmv(torch.zeros(8, 1, dtype=torch.int64),
                         torch.zeros(8, 1, dtype=F64), a)
    with pytest.raises(ValueError, match="exceeds"):
        kernels.primal_update_sym(a, a, a, torch.zeros((), dtype=F64), (3,))



def test_polar_and_subspace_wrappers_reject_bad_input():
    """K5-K8's wrappers check shapes and type pairs before any launch."""
    f32 = torch.float32
    A = torch.zeros(4, 3, dtype=f32)
    with pytest.raises(ValueError, match="shapes"):
        kernels.ns_gemm(A, torch.zeros(4, 2, dtype=f32))
    with pytest.raises(ValueError, match="contiguous rows"):
        kernels.ns_gemm(torch.zeros(3, 4, dtype=f32).T, A)
    with pytest.raises(TypeError):
        kernels.ns_gemm(A, torch.zeros(3, 2, dtype=F64))
    with pytest.raises(ValueError, match="want"):
        kernels.sym(A)
    S = torch.zeros(4, 4, dtype=f32)
    with pytest.raises(TypeError, match="compute dtype"):
        kernels.sym_guard(S, S.double(), S)
    with pytest.raises(ValueError, match="2-d"):
        kernels.cholqr(torch.zeros(5, dtype=f32))
    with pytest.raises(ValueError, match="one"):
        kernels.ritz_accept(A, A[:, :2].contiguous(), None, None, 1e-9,
                            1e-7, False)


def test_cholqr_and_ns_gemm_layout_rules():
    """K7's factor keeps G's packed triangle in shared memory up to
    CHOLQR_SMEM_BYTES: f32 at every k to CHOLQR_MAX_K, f64 to k = 240 (the
    edge the card tests take), past it the leading columns stay in the
    workspace.  K5 reads a column slice or a row slab at its row stride
    (one row: the row's length)."""
    f32 = torch.float32
    assert kernels.cholqr_shared_columns(kernels.CHOLQR_MAX_K, f32) == 0
    assert [kernels.cholqr_shared_columns(k, F64)
            for k in (1, 240, 241, 256)] == [0, 0, 1, 16]
    W = torch.zeros(7, 9, dtype=f32)
    assert kernels._matrix_row_stride("ns_gemm", W[:, 1:], "B") == 9
    assert kernels._matrix_row_stride("ns_gemm", W[3:], "A") == 9
    assert kernels._matrix_row_stride("ns_gemm", W[2:3, :4], "C") == 4
    with pytest.raises(ValueError, match="contiguous rows"):
        kernels._matrix_row_stride("ns_gemm", W.T, "A")


def test_ns_gemm_plain_matches_jax_polar_steps():
    """The plain version of K5 repeats the JAX expressions' rounding: each
    of alpha * C and beta * (A @ B) is rounded, then they are added."""
    rng = np.random.RandomState(4)
    Y = rng.randn(30, 30).astype(np.float32)
    A = Y @ Y
    jY, jA = jnp.asarray(Y), jnp.asarray(A)
    want = np.asarray(jcones.POLAR_QB * jA + jcones.POLAR_QC * (jA @ jA))
    got = kernels.ns_gemm(torch.tensor(A), torch.tensor(A), torch.tensor(A),
                          jcones.POLAR_QB, jcones.POLAR_QC)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    want = np.asarray(1.5 * jY - 0.5 * (jY @ jA))
    got = kernels.ns_gemm(torch.tensor(Y), torch.tensor(A), torch.tensor(Y),
                          1.5, -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
