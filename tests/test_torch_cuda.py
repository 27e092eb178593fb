"""The port on a CUDA card: kernels against their plain versions, and the
iteration on the card against the same iteration on the CPU.

Marked ``cuda``; skipped where ``torch.cuda.is_available()`` is false.
Imports no jax (the CPU path is held to the JAX package by the other
``test_torch_*`` files), so on the card's machine, which has no jax, run
it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import proxsdp_tpu_torch as tx
from proxsdp_tpu_torch import convert, kernels
from proxsdp_tpu_torch import solver as tsolver
from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
from proxsdp_tpu_torch.ops.linop import build_linop
from proxsdp_tpu_torch.problem import preprocess, to_square_form

pytestmark = pytest.mark.cuda

# kernel vs plain version on the card: elementwise results round alike
# (-fmad=false); reductions differ in summation order only
RTOL = {torch.float64: 1e-12, torch.float32: 2e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_cuda.py on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _close(got, want, dtype):
    got = torch.cat([g.reshape(-1) for g in got]).double().cpu()
    want = torch.cat([w.reshape(-1) for w in want]).double().cpu()
    same = got == want  # covers -inf in the residuals' inequality slot
    err = torch.where(same, torch.zeros_like(got), (got - want).abs()).max()
    scale = want[torch.isfinite(want)].abs().max().clamp_min(1e-30)
    assert float(err / scale) <= RTOL[dtype], float(err / scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("side, n_free, p, m", [(7, 5, 3, 4), (33, 0, 33, 0),
                                                (250, 0, 250, 0)])
def test_kernels_match_plain(cuda, dtype, side, n_free, p, m):
    rng = np.random.default_rng(side)
    n = side * side + n_free

    def vec(k):
        return torch.tensor(rng.standard_normal(k), dtype=dtype, device=cuda)

    def scalar(v):
        return torch.tensor(v, dtype=dtype, device=cuda)

    x, x_old, Mty, Mty_old, c = (vec(n) for _ in range(5))
    y, y_old, Mx, Mx_old = (vec(p + m) for _ in range(4))
    b, h = vec(p), vec(m)
    tau, sigma, theta = scalar(0.37), scalar(0.21), scalar(0.93)
    idx = torch.tensor(rng.integers(0, n, (p + m, 3)), dtype=torch.int32,
                       device=cuda)
    vals = vec(3 * (p + m)).view(p + m, 3)
    cases = [
        (kernels.ell_spmv, kernels.ell_spmv_plain, (idx, vals, x)),
        (kernels.ls_dual_update, kernels.ls_dual_update_plain,
         (y, Mx, Mx_old, b, h, y_old, sigma, theta, p, m)),
        (kernels.sq_dist, kernels.sq_dist_plain, (x, x_old)),
        (kernels.residuals, kernels.residuals_plain,
         (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c,
          p, m, side)),
        (kernels.primal_update_sym, kernels.primal_update_sym_plain,
         (x, Mty, c, tau, side)),
    ]
    for wrapper, plain, args in cases:
        kernels.reset_launch_counts()
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts.values()) == 1, wrapper.__name__
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        _close(got, want, dtype)


@pytest.mark.parametrize("side", [30, 50])
def test_iterations_match_cpu(cuda, side):
    """60 iterations on the card (kernels) and on the CPU (plain
    versions) from one init_state, at the tolerance of the JAX parity
    tests (rtol 1e-9, atol 1e-11)."""
    problem, _ = maxcut_problem(random_graph_weights(0, side))
    setup = to_square_form(preprocess(problem))
    layout, opts = setup.layout, tx.Options(hybrid_precision=False)
    host = tsolver.init_state(layout, opts, setup)
    states = {}
    for dev in ("cpu", "cuda"):
        M = build_linop(setup.A, setup.G, torch.float64, device=dev)
        o = convert.operands_from_numpy(
            M=M, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
            norm_h=setup.norm_h, norm_c=setup.norm_c,
            obj_scale=setup.obj_scale * setup.rhs_scale, device=dev)
        run = tsolver.make_chunk_runner(layout, opts, device=dev)[0]
        states[dev] = convert.state_to_numpy(
            run(convert.state_from_numpy(host, dev), o, 60))
    got, want = states["cuda"], states["cpu"]
    for name in want:
        if name == "warm":
            continue  # an eigenvector: its sign is the eigensolver's choice
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-11, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("side, k", [(33, 16), (100, 16), (250, 24)])
def test_new_kernels_match_plain(cuda, dtype, side, k):
    """K5-K8 against their plain versions at the polar and subspace
    steps' shapes, including the guard's bad path and the mixed-type
    entry points."""
    rng = np.random.default_rng(side + k)

    def mat(*shape, dt=dtype):
        return torch.tensor(rng.standard_normal(shape), dtype=dt, device=cuda)

    Y, C, X = mat(side, side), mat(side, side), mat(side, side)
    X = 0.5 * (X + X.T)
    W = mat(side, k + 1)
    cases = [
        (kernels.ns_gemm, kernels.ns_gemm_plain, (Y, Y)),
        (kernels.ns_gemm, kernels.ns_gemm_plain, (Y, C, C, -4.775, 2.0315)),
        (kernels.ns_gemm, kernels.ns_gemm_plain, (Y, C, Y, 1.5, -0.5)),
        (kernels.ns_gemm, kernels.ns_gemm_plain,  # strided column slices
         (Y, W[:, :-1], W[:, :-1], 0.5, 0.5)),
        (kernels.ns_gemm, kernels.ns_gemm_plain, (Y, W[:, -1:], W[:, -1:], 0.5, -0.5)),
        (kernels.fro_scale, kernels.fro_scale_plain, (X, dtype)),
        (kernels.sym, kernels.sym_plain, (Y,)),
        (kernels.sym_guard, kernels.sym_guard_plain, (Y, X, C)),
        (kernels.cholqr, kernels.cholqr_plain,
         (W[:, :k].contiguous(), kernels.CHOLQR_EPS[dtype])),
    ]
    if dtype == torch.float64:
        f32 = X.float()
        cases += [
            (kernels.fro_scale, kernels.fro_scale_plain, (X, torch.float32)),
            (kernels.sym_guard, kernels.sym_guard_plain, (f32, f32, X)),
        ]
    bad = Y.clone()
    bad[1, 2] = float("nan")
    cases.append((kernels.sym_guard, kernels.sym_guard_plain, (bad, X, C)))
    for wrapper, plain, args in cases:
        kernels.reset_launch_counts()
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts.values()) == 1, wrapper.__name__
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, wrapper.__name__
            if not g.is_floating_point():
                assert torch.equal(g.cpu(), w.cpu()), wrapper.__name__
                continue
            nan = torch.isnan(w)
            assert torch.equal(torch.isnan(g), nan), wrapper.__name__
            g, w = g[~nan], w[~nan]
            if w.numel():
                _close((g,), (w,), w.dtype)
    # a non-positive pivot gives NaN, as jnp.linalg.cholesky does
    Q = kernels.cholqr(torch.zeros(side, k, dtype=dtype, device=cuda), -1.0)
    assert torch.isnan(Q).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["accept", "reject", "force_full", "nan"])
def test_ritz_accept_matches_plain(cuda, dtype, case):
    """K8: the same accept decision and rank as its plain version; the
    Rayleigh quotients (theta None, the mixed f64 mode) and the stats to
    RTOL of the dtype."""
    side, k = 250, 16
    rng = np.random.default_rng(7)
    Wn, _ = np.linalg.qr(rng.standard_normal((side, k)))
    theta = np.concatenate([np.linspace(9.0, 1.0, 8), -np.linspace(0.5, 4.0, 8)])
    noise = {"reject": 1e-2}.get(case, 1e-9)
    XW = Wn * theta + noise * rng.standard_normal((side, k))
    if case == "nan":
        XW[5, 3] = np.nan
    W = torch.tensor(Wn, dtype=dtype, device=cuda)
    XWt = torch.tensor(XW, dtype=dtype, device=cuda)
    th = None if dtype == torch.float64 else torch.tensor(theta, dtype=dtype,
                                                          device=cuda)
    at = torch.tensor(1e-4, dtype=dtype, device=cuda)
    args = (W, XWt, th, at, 1e-9, 1e-7, case == "force_full")
    kernels.reset_launch_counts()
    lam, stats, flags = kernels.ritz_accept(*args)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["ritz_accept"] == 1
    plam, pstats, pflags = kernels.ritz_accept_plain(*args)
    assert torch.equal(flags.cpu(), pflags.cpu()), (flags, pflags)
    assert int(flags[0]) == (case == "accept")
    for g, w in ((lam, plam), (stats, pstats)):
        nan = torch.isnan(w)
        assert torch.equal(torch.isnan(g), nan)
        _close((g[~nan],), (w[~nan],), dtype)


@pytest.mark.parametrize("side, n_free, p, m", [(7, 5, 3, 4), (250, 0, 250, 0)])
def test_residuals_f32_matches_repaired_plain(cuda, side, n_free, p, m):
    """K3's f32 program: f32 maxima and two-stage dots, f64 outputs; the
    plain version repeats the kernel's chunk order, so every slot agrees
    to f64 rounding (the f64 sum of the chunks runs in another order)."""
    rng = np.random.default_rng(side)
    n = side * side + n_free

    def vec(k):
        return torch.tensor(rng.standard_normal(k), dtype=torch.float32,
                            device=cuda)

    x, x_old, Mty, Mty_old, c = (vec(n) for _ in range(5))
    y, y_old, Mx, Mx_old = (vec(p + m) for _ in range(4))
    b, h = vec(p), vec(m)
    tau = torch.tensor(0.37, dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.21, dtype=torch.float32, device=cuda)
    args = (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c,
            p, m, side)
    got = kernels.residuals(*args)
    torch.cuda.synchronize()
    want = kernels.residuals_plain(*args)
    assert got.dtype == want.dtype == torch.float64
    same = got == want
    err = torch.where(same, torch.zeros_like(got), (got - want).abs())
    assert float((err / want.abs().clamp_min(1e-30)).max()) <= 1e-12


def test_hybrid_solve_on_card_matches_cpu(cuda):
    """The default Options() (hybrid race and polish) at side 50 on the card
    against the CPU path; every kernel of the path launches."""
    problem, _ = maxcut_problem(random_graph_weights(0, 50))
    opts = tx.Options(chunk_iters=256)
    kernels.reset_launch_counts()
    got = tx.solve(problem, opts)  # the card is the default device
    counts = kernels.kernel_launches()
    want = tx.solve(problem, opts, device="cpu")
    assert got.status == want.status == 1
    assert abs(got.iter - want.iter) <= max(5, 0.05 * want.iter)
    assert abs(got.objval - want.objval) <= 1e-4 * (1 + abs(want.objval))
    for name in kernels.SOLVE_KERNELS:
        assert counts[name] > 0, name


def test_solve_on_card_matches_cpu(cuda):
    problem, _ = maxcut_problem(random_graph_weights(0, 50))
    opts = tx.Options(hybrid_precision=False)
    kernels.reset_launch_counts()
    got = tx.solve(problem, opts, device="cuda")
    counts = kernels.kernel_launches()
    want = tx.solve(problem, opts, device="cpu")
    assert got.status == want.status == 1
    assert abs(got.iter - want.iter) <= max(2, 0.02 * want.iter)
    assert abs(got.objval - want.objval) <= 1e-4 * (1 + abs(want.objval))
    assert counts["ell_spmv"] >= 2 * got.iter
    for name in ("ls_dual_update", "sq_dist", "residuals", "primal_update_sym"):
        assert counts[name] >= got.iter, name


@pytest.mark.parametrize("how", ["set_float32_matmul_precision", "fp32_precision"])
def test_solve_ignores_tf32(cuda, how):
    """A caller who turns TF32 on gets the same default solve: the solve
    runs torch's own products (the subspace step's tall-skinny GEMMs and
    reconstructions) in IEEE f32 and puts the caller's setting back.  The
    solve's body without the pin does change under TF32, so the comparison
    can fail."""
    problem, _ = maxcut_problem(random_graph_weights(0, 50))
    opts = tx.Options(chunk_iters=256)
    want = tx.solve(problem, opts)
    if how == "set_float32_matmul_precision":
        torch.set_float32_matmul_precision("high")
    else:
        torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        got = tx.solve(problem, opts)
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
        bare = tsolver._solve(problem, opts, "cuda", {})
    finally:
        torch.backends.cuda.matmul.fp32_precision = "ieee"
    assert (got.status, got.iter, got.objval) == (want.status, want.iter,
                                                   want.objval)
    np.testing.assert_array_equal(got.primal, want.primal)
    assert (bare.iter, bare.objval) != (want.iter, want.objval)


# ---------------------------------------------------------------- the batch

# K9 against torch.linalg.eigh (LAPACK-grade on both sides): the projection
# and the eigenvalues of two backward-stable eigensolvers differ by a few
# s * eps * ||X||; held relative to the batch's largest entry
EIGH_RTOL = {torch.float64: 1e-11, torch.float32: 1e-4}


def _eigh_batch(rng, B, side, dtype, device):
    """B symmetric matrices: random ones, every third rank-deficient (half
    its eigenvalues exactly 0), and instance 1 with a NaN entry."""
    X = rng.standard_normal((B, side, side))
    X = 0.5 * (X + X.transpose(0, 2, 1))
    for b in range(0, B, 3):
        V, _ = np.linalg.qr(rng.standard_normal((side, side)))
        w = rng.standard_normal(side) * 3.0
        w[: side // 2] = 0.0
        X[b] = (V * w) @ V.T
    X = torch.tensor(X, dtype=dtype, device=device)
    if B > 1:
        X[1, 0, side - 1] = float("nan")
    return X


def _check_eigh(got, want, X, tol_psd):
    Xp, w, rank, warm = got
    pXp, pw, prank, pwarm = want
    dtype = X.dtype
    finite = torch.isfinite(X).all(dim=(1, 2)).cpu()
    assert torch.equal(torch.isnan(Xp).all(dim=(1, 2)).cpu(), ~finite)
    assert torch.equal(torch.isnan(w).all(dim=1).cpu(), ~finite)
    assert torch.equal(torch.isnan(warm).all(dim=1).cpu(), ~finite)
    assert (rank.cpu()[~finite] == 0).all()
    f = finite.to(X.device)
    scale = float(X[f].abs().max())
    tol = EIGH_RTOL[dtype] * scale
    assert float((Xp[f] - pXp[f]).abs().max()) <= tol
    assert float((w[f] - pw[f]).abs().max()) <= tol
    # Xp is symmetric bit for bit (the kernel mirrors the upper triangle)
    assert torch.equal(Xp[f], Xp[f].transpose(1, 2))
    # ranks where no eigenvalue sits within the tolerance of tol_psd
    clear = ((pw[f] - tol_psd).abs() > tol).all(dim=1)
    assert torch.equal(rank[f][clear].cpu(), prank[f][clear].cpu())
    # warm: the top eigenvector up to sign, where the top eigenvalue is simple
    gap = pw[f][:, -1] - pw[f][:, -2] if X.shape[1] > 1 else pw[f][:, -1] + 1
    simple = gap > 1e-3 * scale
    dots = torch.sum(warm[f] * pwarm[f], dim=1).abs()[simple]
    if dots.numel():
        assert float((1 - dots).abs().max()) <= (
            1e-6 if dtype == torch.float64 else 1e-3)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("side", [1, 2, 10, 16, 31, 32, 33, 40, 64])
def test_batched_psd_eigh_matches_plain(cuda, dtype, side):
    """K9 against its plain version (torch.linalg.eigh) on random,
    rank-deficient and non-finite instances."""
    rng = np.random.default_rng(side)
    X = _eigh_batch(rng, 64, side, dtype, cuda)
    kernels.reset_launch_counts()
    got = kernels.batched_psd_eigh(X, 1e-7)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["batched_psd_eigh"] == 1
    _check_eigh(got, kernels.batched_psd_eigh_plain(X, 1e-7), X, 1e-7)


def test_batched_psd_eigh_limits(cuda):
    X = torch.zeros(2, 65, 65, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.batched_psd_eigh(X, 1e-7)
    # the zero matrix: projection 0, rank 0, a unit warm vector
    Xp, w, rank, warm = kernels.batched_psd_eigh(X[:, :16, :16].contiguous(),
                                                 1e-7)
    assert float(Xp.abs().max()) == 0.0 and float(w.abs().max()) == 0.0
    assert int(rank.max()) == 0
    np.testing.assert_allclose(warm.norm(dim=1).cpu().numpy(), 1.0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_kernels_match_plain(cuda, dtype):
    """The batched K1-K4 entry points and K10 against their plain
    versions; K10 and the elementwise updates round alike (-fmad=false)."""
    rng = np.random.default_rng(3)
    B, side, n_free, p, m = 37, 9, 3, 6, 4
    tl = side * (side + 1) // 2
    n = tl + n_free

    def rows(k):
        return torch.tensor(rng.standard_normal((B, k)), dtype=dtype,
                            device=cuda)

    x, x_old, Mty, Mty_old, c = (rows(n) for _ in range(5))
    y, y_old, Mx, Mx_old = (rows(p + m) for _ in range(4))
    b, h = rows(p), rows(m)
    tau, sigma, theta = (torch.tensor(rng.uniform(0.1, 1.0, B), dtype=dtype,
                                      device=cuda) for _ in range(3))
    idx = torch.tensor(rng.integers(0, n, (p + m, 3)), dtype=torch.int32,
                       device=cuda)
    vals = torch.tensor(rng.standard_normal((p + m, 3)), dtype=dtype,
                        device=cuda)
    S = kernels.tri_to_square_plain(x, side)
    cases = [
        (kernels.ell_spmv_batch, kernels.ell_spmv_batch_plain, (idx, vals, x)),
        (kernels.ls_dual_update_batch, kernels.ls_dual_update_batch_plain,
         (y, Mx, Mx_old, b, h, y_old, sigma, theta, p, m)),
        (kernels.sq_dist_batch, kernels.sq_dist_batch_plain, (x, x_old)),
        (kernels.residuals_batch, kernels.residuals_batch_plain,
         (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c,
          p, m)),
        (kernels.primal_update_batch, kernels.primal_update_batch_plain,
         (x, Mty, c, tau)),
        (kernels.tri_to_square, kernels.tri_to_square_plain, (x, side)),
        (kernels.square_to_tri, kernels.square_to_tri_plain, (S, side)),
    ]
    for wrapper, plain, args in cases:
        kernels.reset_launch_counts()
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts.values()) == 1, wrapper.__name__
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, wrapper.__name__
        if wrapper in (kernels.tri_to_square, kernels.square_to_tri,
                       kernels.primal_update_batch):
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            _close(got, want, dtype)


def test_solve_batch_on_card_matches_cpu(cuda):
    """solve_batch at B = 64, side 16 on the card against its CPU plain
    run, f64 program: the same statuses, iterations within 2 %, objectives
    to 1e-6; every batched kernel launches."""
    from proxsdp_tpu_torch.parallel.batch import solve_batch

    problems = [maxcut_problem(random_graph_weights(s, 16))[0]
                for s in range(64)]
    opts = tx.Options(tol_gap=1e-4, tol_feasibility=1e-4,
                      hybrid_precision=False)
    kernels.reset_launch_counts()
    got = solve_batch(problems, opts)  # the card is the default device
    counts = kernels.kernel_launches()
    want = solve_batch(problems, opts, device="cpu")
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert abs(g.iter - w.iter) <= max(2, 0.02 * w.iter)
        assert abs(g.objval - w.objval) <= 1e-6 * (1 + abs(w.objval))
    for name in kernels.BATCH_KERNELS:
        assert counts[name] > 0, name
