"""The port on a CUDA card: kernels against their plain versions, and the
iteration on the card against the same iteration on the CPU.

Marked ``cuda``; skipped where ``torch.cuda.is_available()`` is false.
Imports no jax (the CPU path is held to the JAX package by the other
``test_torch_*`` files), so on the card's machine, which has no jax, run
it without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import hashlib

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
          p, m, (side,))),
        (kernels.primal_update_sym, kernels.primal_update_sym_plain,
         (x, Mty, c, tau, (side,))),
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
            p, m, (side,))
    got = kernels.residuals(*args)
    torch.cuda.synchronize()
    want = kernels.residuals_plain(*args)
    assert got.dtype == want.dtype == torch.float64
    same = got == want
    err = torch.where(same, torch.zeros_like(got), (got - want).abs())
    assert float((err / want.abs().clamp_min(1e-30)).max()) <= 1e-12


# a block table with grouped, single and side-1 blocks, and a tail of SOC
# and LP coordinates after it
BLOCK_SIDES = (3, 3, 40, 1, 33, 19, 19)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_residuals_blocks_and_row_scale_match_plain(cuda, dtype):
    """K3 with a row scale and a table of square blocks against its plain
    version; a row scale of ones gives the bits of no row scale."""
    rng = np.random.default_rng(13)
    n = sum(s * s for s in BLOCK_SIDES) + 37
    p, m = 41, 23

    def vec(k, lo=None):
        v = rng.standard_normal(k) if lo is None else rng.uniform(lo, 3.0, k)
        return torch.tensor(v, dtype=dtype, device=cuda)

    x, x_old, Mty, Mty_old, c = (vec(n) for _ in range(5))
    y, y_old, Mx, Mx_old = (vec(p + m) for _ in range(4))
    b, h, rs = vec(p), vec(m), vec(p + m, 0.01)
    tau = torch.tensor(0.37, dtype=dtype, device=cuda)
    sigma = torch.tensor(0.21, dtype=dtype, device=cuda)
    args = (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c,
            p, m, BLOCK_SIDES)
    kernels.reset_launch_counts()
    got = kernels.residuals(*args, row_scale=rs)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["residuals"] == 1
    sfx = "f64" if dtype == torch.float64 else "f32"
    assert kernels.row_scale_launches[sfx] == 1
    kernels.residuals(*args)
    assert kernels.row_scale_launches[sfx] == 1
    want = kernels.residuals_plain(*args, row_scale=rs)
    same = got == want
    err = torch.where(same, torch.zeros_like(got), (got - want).abs())
    assert float((err / want.abs().clamp_min(1e-30)).max()) <= 1e-12
    assert torch.equal(kernels.residuals(*args, row_scale=torch.ones_like(rs)),
                       kernels.residuals(*args))
    assert not torch.equal(got[4:6], kernels.residuals(*args)[4:6])


# sha256 (first 16 hex digits) of the outputs of K3 and K4 with one block
# at offset 0 and no row scale -- side 250 (max-cut's n, p, m = 62,500,
# 250, 0) and side 33 with a tail of 37 (p = 41, m = 23) -- as the
# single-block kernels that the block table replaced (residuals.cu and
# primal_update_sym.cu of commit 1bba2e9) gave them on an H100
ONE_BLOCK_SHA = {
    (250, torch.float64): ("5ed75a93e065106b", "12569c53f848d74f"),
    (250, torch.float32): ("7b34170946599cee", "6dae3a75997f8494"),
    (33, torch.float64): ("682f8584ee6eb3ff", "29626608e541f62a"),
    (33, torch.float32): ("42794fed87f9f6c5", "cc7407cf99c1f498"),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("side, tail, p, m", [(250, 0, 250, 0), (33, 37, 41, 23)])
def test_one_block_kernels_keep_single_block_bits(cuda, dtype, side, tail, p, m):
    """K3 and K4 with the old arguments (one block at offset 0, no row
    scale) give the single-block kernels' results bit for bit."""
    rng = np.random.default_rng(side)
    n = side * side + tail

    def vec(k):
        return torch.tensor(rng.standard_normal(k), dtype=dtype, device=cuda)

    x, x_old, Mty, Mty_old, c = (vec(n) for _ in range(5))
    y, y_old, Mx, Mx_old = (vec(p + m) for _ in range(4))
    b, h = vec(p), vec(m)
    tau = torch.tensor(0.37, dtype=dtype, device=cuda)
    sigma = torch.tensor(0.21, dtype=dtype, device=cuda)
    r = kernels.residuals(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old,
                          sigma, b, h, c, p, m, (side,))
    u = kernels.primal_update_sym(x, Mty, c, tau, (side,))
    got = tuple(hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
                for t in (r, u))
    assert got == ONE_BLOCK_SHA[side, dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_primal_update_sym_blocks_match_plain(cuda, dtype):
    """K4 over a block table: one launch, every block symmetrised, every
    entry equal to the plain version's (elementwise, -fmad=false)."""
    rng = np.random.default_rng(14)
    n = sum(s * s for s in BLOCK_SIDES) + 37
    x, Mty, c = (torch.tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
                 for _ in range(3))
    tau = torch.tensor(0.43, dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    got = kernels.primal_update_sym(x, Mty, c, tau, BLOCK_SIDES)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["primal_update_sym"] == 1
    assert torch.equal(got, kernels.primal_update_sym_plain(x, Mty, c, tau,
                                                            BLOCK_SIDES))


def soc_inputs(rng, nblk, dtype, device):
    """nblk SOC blocks of lengths 2-257 in the three cases of
    cones.py:50-55 in turn (inside, polar, outside) and every fourth with
    v = 0 and s < 0."""
    lens = tuple(2 + (37 * i) % 256 for i in range(nblk))
    parts = []
    for i, ln in enumerate(lens):
        v = rng.standard_normal(ln - 1)
        nv = np.linalg.norm(v)
        s = (2.0 * nv, -1.5 * nv, 0.3 * nv, -0.7)[i % 4]
        parts.append(np.concatenate([[s], 0.0 * v if i % 4 == 3 else v]))
    return torch.tensor(np.concatenate(parts), dtype=dtype, device=device), lens


@pytest.mark.parametrize("nblk", [128, 4096])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_soc_projection_matches_plain(cuda, dtype, nblk):
    """K13 against its plain version, bit for bit: the projection and the
    largest gap (the norms summed in the kernel's order)."""
    v, lens = soc_inputs(np.random.default_rng(nblk), nblk, dtype, cuda)
    kernels.reset_launch_counts()
    got, gap = kernels.soc_projection(v, lens)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["soc_projection"] == 1
    want, wgap = kernels.soc_projection_plain(v, lens)
    assert torch.equal(got, want) and torch.equal(gap, wgap)
    again, gap2 = kernels.soc_projection(v, lens)
    assert torch.equal(again, got) and torch.equal(gap2, gap)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_coo_spmv_matches_plain(cuda, dtype):
    """K14 on an operator the auto policy sends to COO (a trace row of
    side 60 beside 2500 single-entry rows): both products against the
    plain version, and a repeat gives the same bits."""
    from proxsdp_tpu_torch.ops.linop import build_linop
    import scipy.sparse as sp

    rng = np.random.default_rng(15)
    side, m = 60, 2500
    n = side * side
    rows = np.concatenate([np.zeros(side, np.int64), 1 + np.arange(m)])
    cols = np.concatenate([np.arange(side) * (side + 1),
                           rng.choice(n, m, replace=False)])
    A = sp.csr_matrix((rng.standard_normal(side + m), (rows, cols)),
                      shape=(m + 1, n))
    M = build_linop(A, sp.csr_matrix((0, n)), dtype, device=cuda)
    assert type(M).__name__ == "CooOp"
    x = torch.tensor(rng.standard_normal(n), dtype=dtype, device=cuda)
    y = torch.tensor(rng.standard_normal(m + 1), dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    got = (M.matvec(x), M.rmatvec(y))
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["coo_spmv"] == 2
    want = (kernels.coo_spmv_plain(M.row_ptr, M.row_idx, M.row_vals, x,
                                   M.row_seg),
            kernels.coo_spmv_plain(M.col_ptr, M.col_idx, M.col_vals, y,
                                   M.col_seg))
    _close(got, want, dtype)
    assert torch.equal(M.matvec(x), got[0])


def test_multiblock_solve_on_card_matches_cpu(cuda):
    """Grouped same-side blocks (K9), single blocks, SOC blocks (K13) and
    LP coordinates through the f64 program on the card and on the CPU."""
    import chip_smoke

    data = chip_smoke.conic_program_data(seed=1, sides=(3, 5, 3, 6, 3),
                                         soc_lens=(4, 5, 4), n_lp=6, rows=16,
                                         density=0.3)
    problem = chip_smoke.build_conic_program(tx, data)[0]
    opts = tx.Options(hybrid_precision=False)
    kernels.reset_launch_counts()
    got = tx.solve(problem, opts)
    counts = kernels.kernel_launches()
    want = tx.solve(problem, opts, device="cpu")
    assert got.status == want.status == 1
    assert abs(got.iter - want.iter) <= max(2, 0.02 * want.iter)
    assert abs(got.objval - want.objval) <= 1e-6 * (1 + abs(want.objval))
    for name in ("batched_psd_eigh", "soc_projection", "residuals",
                 "primal_update_sym"):
        assert counts[name] >= got.iter, name


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
        # K11 runs only above full_eig_max_side (the Lanczos program),
        # K13 only on SOC blocks, K14 only on a COO operator, K17 only
        # under subspace_sign=True (test_single_solve_options_on_card_...)
        assert counts[name] > 0 or name in ("lanczos_krylov", "soc_projection",
                                            "coo_spmv", "subspace_sign"), name


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
    # K1 for M x; M' y runs inside K15, one launch an iteration
    assert counts["ell_spmv"] >= got.iter
    for name in ("linesearch_loop", "residuals", "primal_update_sym"):
        assert counts[name] >= got.iter, name
    assert counts["ls_dual_update"] == counts["sq_dist"] == 0


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


def _check_eigh(got, want, X, tol_psd, rtol=None):
    Xp, w, rank, warm = got
    pXp, pw, prank, pwarm = want
    dtype = X.dtype
    rtol = EIGH_RTOL[dtype] if rtol is None else rtol
    finite = torch.isfinite(X).all(dim=(1, 2)).cpu()
    assert torch.equal(torch.isnan(Xp).all(dim=(1, 2)).cpu(), ~finite)
    assert torch.equal(torch.isnan(w).all(dim=1).cpu(), ~finite)
    assert torch.equal(torch.isnan(warm).all(dim=1).cpu(), ~finite)
    assert (rank.cpu()[~finite] == 0).all()
    f = finite.to(X.device)
    scale = float(X[f].abs().max())
    tol = rtol * scale
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


@pytest.mark.parametrize("dtype, side", [
    (torch.float64, 65), (torch.float64, 100), (torch.float64, 118),
    (torch.float32, 100), (torch.float32, 168)])
def test_batched_psd_eigh_wide_sides(cuda, dtype, side):
    """K9 past side 64, up to its shared-memory limit per type (118 in
    f64, 168 in f32), against its plain version, to EIGH_RTOL; at side
    168 in f32 the rotations' rounding puts the eigenvalues 1.41e-4 of the
    scale from cuSOLVER's (on an H100), held to 1.5e-4."""
    rng = np.random.default_rng(side)
    X = _eigh_batch(rng, 16, side, dtype, cuda)
    kernels.reset_launch_counts()
    got = kernels.batched_psd_eigh(X, 1e-7)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["batched_psd_eigh"] == 1
    _check_eigh(got, kernels.batched_psd_eigh_plain(X, 1e-7), X, 1e-7,
                rtol=1.5e-4 if side > 118 else EIGH_RTOL[dtype])


def test_batched_psd_eigh_limits(cuda):
    """K9 to side 118 (f64) / 168 (f32), K9L from the next side."""
    for dtype, side in ((torch.float64, 118), (torch.float64, 119),
                        (torch.float32, 168), (torch.float32, 169)):
        X = torch.zeros(2, side, side, dtype=dtype, device=cuda)
        kernels.reset_launch_counts()
        kernels.batched_psd_eigh(X, 1e-7)
        torch.cuda.synchronize()
        large = side > kernels.EIGH_MAX_SIDE[dtype]
        assert kernels.kernel_launches()["batched_psd_eigh_large"] == large
        assert kernels.kernel_launches()["batched_psd_eigh"] == (not large)
    X = torch.zeros(2, 65, 65, dtype=torch.float64, device=cuda)
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
    to 1e-6; every batched kernel of the eigh mode launches (K12 runs in
    the subspace mode: test_solve_batch_subspace_on_card_matches_cpu)."""
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
        # K12 runs in the subspace mode, K16 only on per-instance dense
        # operators (test_solve_batch_per_instance_on_card_matches_cpu),
        # K9L and K12L past one block's shared memory, K5b and K6b under
        # projection="polar" (test_solve_batch_large_on_card_matches_cpu),
        # K13b only on SOC blocks and K14b only on a COO operator
        # (test_solve_batch_layouts_on_card_matches_cpu)
        assert counts[name] > 0 or name in (
            "batched_subspace", "batched_gemv", "batched_psd_eigh_large",
            "batched_subspace_large", "ns_gemm_batch", "fro_scale_batch",
            "sym_batch", "sym_guard_batch", "soc_projection_batch",
            "coo_spmv_batch"), name


# K12 against its plain version: f64 sums in other orders and Jacobi for
# LAPACK's k x k eigh; f32 and the mixed mode build the basis in f32
SUB_TOL = {"f64": 1e-10, "f32": 1e-4, "mixed": 1e-4}


def _subspace_inputs(rng, B, side, k, dtype, device):
    """Packed blocks with six clear positive eigenvalues and orthonormal
    bases; instance 1 has a NaN entry, instance 2 is exactly 0."""
    Q, _ = np.linalg.qr(rng.standard_normal((B, side, side)))
    w = rng.standard_normal((B, side))
    w[:, :6] = 5.0 + 3.0 * rng.random((B, 6))
    X = np.einsum("bik,bk,bjk->bij", Q, w, Q)
    X[2] = 0.0
    V, _ = np.linalg.qr(rng.standard_normal((B, side, k)))
    v = kernels.square_to_tri_plain(torch.tensor(X), side)
    v[1, 3] = float("nan")
    return v.to(dtype).to(device), torch.tensor(V, dtype=dtype, device=device)


def _check_subspace(got, want, v, V, side, mode, tols=None):
    blk, me, rank, warm, bad, stats = got
    pblk, pme, prank, pwarm, pbad, pstats = want
    tol = (tols or SUB_TOL)[mode]
    scale = float(v[torch.isfinite(v)].abs().max())
    assert torch.equal(bad, pbad)
    assert bad.tolist()[:3] == [False, True, False]
    assert torch.equal(torch.isnan(blk), torch.isnan(pblk))
    fin = torch.isfinite(pblk)
    assert float((blk[fin] - pblk[fin]).abs().max()) <= tol * scale
    assert torch.equal(torch.isnan(me), torch.isnan(pme))
    ok = ~bad
    assert float((me[ok] - pme[ok]).abs().max()) <= tol * scale
    assert torch.equal(rank, prank)
    assert torch.equal(stats[:, 2], pstats[:, 2])
    assert float((stats[ok, :2] - pstats[ok, :2]).abs().max()) <= tol * scale
    assert torch.equal(warm[bad], V[bad])
    # Ritz vectors up to sign, where the Ritz value is simple
    X = kernels.tri_to_square_plain(torch.nan_to_num(v), side).double()
    W = pwarm.double()
    th = torch.einsum("bik,bij,bjk->bk", W, X, W)
    for b in torch.nonzero(ok).flatten().tolist():
        d = torch.diff(th[b])
        gap = torch.minimum(torch.cat([d.abs(), d.new_tensor([float("inf")])]),
                            torch.cat([d.new_tensor([float("inf")]), d.abs()]))
        simple = gap > 1e-3 * scale
        dots = torch.sum(warm[b].double() * W[b], dim=0).abs()[simple]
        if dots.numel():
            assert float((1 - dots).abs().max()) <= max(tol, 1e-8)


@pytest.mark.parametrize("mode", ["f64", "mixed", "f32"])
@pytest.mark.parametrize("side, k", [(40, 16), (100, 16), (100, 24),
                                     (100, 48)])
def test_batched_subspace_matches_plain(cuda, mode, side, k):
    """K12 against its plain version in each mode: projected blocks, min
    eigenvalue, rank, guard, sub_stats and bases; a non-finite instance
    keeps its block and basis, a zero one its basis (C11)."""
    dtype = torch.float32 if mode == "f32" else torch.float64
    v, V = _subspace_inputs(np.random.default_rng(side + k), 8, side, k,
                            dtype, cuda)
    kernels.reset_launch_counts()
    got = kernels.batched_subspace(v, V, side, 1e-7, mode == "mixed")
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts.values()) == 1
    want = kernels.batched_subspace_plain(v, V, side, 1e-7, mode == "mixed")
    _check_subspace(got, want, v, V, side, mode)


# the mixed mode's f64 Rayleigh quotients on bases spanning the top
# eigenvectors: second order in the f32 basis' rounding, while an f32
# eigh's Ritz values lie 5e-6 to 1.3e-5 away (chip_smoke.py's
# SUB_THETA_RTOL)
SUB_THETA_TOL = 1e-8


def _thetas(out, side):
    """Ritz values of a K12 output in f64: theta_j of each positive pair as
    w_j^T Xp w_j / |w_j|^4 from the blocks and the basis, min_eig and
    stats' min theta."""
    blk, me, _, warm, _, stats = out
    W = warm.double()
    Xp = kernels.tri_to_square_plain(blk.double(), side)
    th = torch.einsum("bik,bij,bjk->bk", W, Xp, W) / torch.sum(W * W, 1) ** 2
    return th, me.double(), stats[:, 1].double()


def _theta_err(got, want, side, scale):
    ok = ~want[4]
    return max(float((a[ok] - b[ok]).abs().max())
               for a, b in zip(_thetas(got, side), _thetas(want, side))) / scale


@pytest.mark.parametrize("side, k", [(40, 16), (100, 16), (100, 24),
                                     (500, 24), (500, 96)])
def test_batched_subspace_mixed_rayleigh_quotients(cuda, side, k):
    """The mixed mode's f64 Rayleigh quotients: on bases that span the top
    eigenvectors K12's Ritz values, min_eig and stats' min theta agree with
    the plain version's to SUB_THETA_TOL of the largest entry, and the f32
    mode on the same inputs (Ritz values and XW in f32) fails that bound.
    At side 500 (K12L) the bound is SUB_THETA_TOL_LARGE, and the control
    is not run (the f32 mode's error there is of the bound's order)."""
    rng = np.random.default_rng(side + k)
    v, V = _subspace_inputs(rng, 8, side, k, torch.float64, cuda)
    _, Q = torch.linalg.eigh(kernels.tri_to_square_plain(
        torch.nan_to_num(v), side))
    R = torch.linalg.qr(torch.tensor(rng.standard_normal((8, k, k)),
                                     dtype=torch.float64, device=cuda)).Q
    V = (Q.flip(-1)[:, :, :k] @ R).contiguous()
    got = kernels.batched_subspace(v, V, side, 1e-7, True)
    want = kernels.batched_subspace_plain(v, V, side, 1e-7, True)
    scale = float(v[torch.isfinite(v)].abs().max())
    assert torch.equal(got[4], want[4])
    err = _theta_err(got, want, side, scale)
    print(f"mixed side {side} k = {k}: Ritz values {err:.3e} of the scale "
          "from the plain version's")
    if side > 130:
        assert err <= SUB_THETA_TOL_LARGE
        return
    assert err <= SUB_THETA_TOL
    ctl = kernels.batched_subspace_plain(v.float(), V.float(), side, 1e-7, False)
    assert _theta_err(ctl, want, side, scale) > SUB_THETA_TOL


def test_batched_subspace_limits(cuda):
    """A working set past one block's shared memory (k = 48 in f64 at
    side 130) or k > 64 runs K12L; k above the largest bucket raises."""
    for side, k, large in ((118, 48, False), (130, 48, True),
                           (200, 96, True)):
        v = torch.zeros(2, side * (side + 1) // 2, dtype=torch.float64,
                        device=cuda)
        V = torch.zeros(2, side, k, dtype=torch.float64, device=cuda)
        kernels.reset_launch_counts()
        kernels.batched_subspace(v, V, side, 1e-7)
        torch.cuda.synchronize()
        assert kernels.kernel_launches()["batched_subspace_large"] == large
    V = torch.zeros(2, 300, 257, dtype=torch.float64, device=cuda)
    v = torch.zeros(2, 300 * 301 // 2, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="largest subspace bucket"):
        kernels.batched_subspace(v, V, 300, 1e-7)


# K12L at side 500 (chip_smoke.py's SUB_RTOL_L, SUB_THETA_RTOL_L): f32
# sums of 500 terms, and the f32 k x k eigensolvers' Ritz vectors; K9L's
# f32 rows against the f32 eigh, per unit of side (chip_smoke.py's
# EIGH_RTOL_F32_L)
EIGH_RTOL_F32_L = 7e-6
SUB_TOL_LARGE = {"f64": 1e-10, "f32": 3e-4, "mixed": 3e-4}
# past k = 128 (chip_smoke.py's SUB_RTOL_L_WIDE): f32 readings to 5.0e-4
SUB_TOL_WIDE = {"f64": 1e-10, "f32": 1e-3, "mixed": 3e-4}
SUB_THETA_TOL_LARGE = 1e-5


@pytest.mark.parametrize("dtype, side", [
    (torch.float64, 119), (torch.float64, 169), (torch.float64, 250),
    (torch.float64, 500), (torch.float32, 169), (torch.float32, 250),
    (torch.float32, 500)])
def test_batched_psd_eigh_large_matches_plain(cuda, dtype, side):
    """K9L (past K9's shared memory) against its plain version: in f64 to
    EIGH_RTOL at every side; an f32 input, which K9L works in f64 and
    rounds, against the f32 eigh to EIGH_RTOL_F32_L times the side (the
    f32 eigh's own distance: chip_smoke.py); ranks, NaN instance and warm
    vectors as K9's."""
    rng = np.random.default_rng(side)
    X = _eigh_batch(rng, 6, side, dtype, cuda)
    kernels.reset_launch_counts()
    got = kernels.batched_psd_eigh(X, 1e-7)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["batched_psd_eigh_large"] == 1
    want = kernels.batched_psd_eigh_plain(X, 1e-7)
    f = torch.isfinite(X).all(dim=(1, 2))
    print(f"K9L {dtype} side {side}: projection "
          f"{float((got[0][f] - want[0][f]).abs().max() / X[f].abs().max()):.3e}"
          f", eigenvalues "
          f"{float((got[1][f] - want[1][f]).abs().max() / X[f].abs().max()):.3e}"
          " of the scale")
    _check_eigh(got, want, X, 1e-7, rtol=EIGH_RTOL_F32_L * side
                if dtype == torch.float32 else None)


def test_batched_psd_eigh_large_many_matrices(cuda):
    """K9L on more matrices than the card keeps resident at two CTAs a
    matrix: one CTA a matrix, the batch in several cooperative launches,
    against the plain version to EIGH_RTOL."""
    X = _eigh_batch(np.random.default_rng(600), 600, 120, torch.float64, cuda)
    kernels.reset_launch_counts()
    got = kernels.batched_psd_eigh(X, 1e-7)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["batched_psd_eigh_large"] == 1
    _check_eigh(got, kernels.batched_psd_eigh_plain(X, 1e-7), X, 1e-7)


@pytest.mark.parametrize("mode", ["f64", "mixed", "f32"])
@pytest.mark.parametrize("side, k", [(130, 64), (500, 24), (500, 32),
                                     (500, 96), (500, 128), (500, 192),
                                     (500, 256)])
def test_batched_subspace_large_matches_plain(cuda, mode, side, k):
    """K12L against its plain version in each mode (K12's checks), where
    the working set passes one block's shared memory or k > 64 (side 500,
    k = 24 in f32 is K12's: checked for the route)."""
    dtype = torch.float32 if mode == "f32" else torch.float64
    v, V = _subspace_inputs(np.random.default_rng(side + k), 6, side, k,
                            dtype, cuda)
    kernels.reset_launch_counts()
    got = kernels.batched_subspace(v, V, side, 1e-7, mode == "mixed")
    torch.cuda.synchronize()
    fits = kernels.subspace_smem_bytes(side, k, dtype, mode == "mixed") \
        <= kernels.SUBSPACE_SMEM_BYTES and k <= kernels.SUBSPACE_MAX_K
    assert kernels.kernel_launches()["batched_subspace_large"] == (not fits)
    want = kernels.batched_subspace_plain(v, V, side, 1e-7, mode == "mixed")
    _check_subspace(got, want, v, V, side, mode,
                    SUB_TOL if side <= 130 else
                    SUB_TOL_LARGE if k <= 128 else SUB_TOL_WIDE)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B, side", [(16, 250), (3, 100), (2, 33)])
def test_batched_polar_kernels_match_plain(cuda, dtype, B, side):
    """K5b and K6b against their plain versions (K5's and K6's
    tolerances), one launch each; polar_psd_batch against its plain run,
    a non-finite instance passed through with rank = side."""
    from proxsdp_tpu_torch.ops.cones import polar_psd_batch

    rng = np.random.default_rng(side)
    sfx = "f64" if dtype == torch.float64 else "f32"
    X = _eigh_batch(rng, B, side, dtype, cuda)
    Xf = torch.nan_to_num(X)
    C = Xf.flip(2).contiguous()
    for name, args in (("ns_gemm_batch", (Xf, C, Xf, 0.5, -1.5)),
                       ("ns_gemm_batch", (Xf, C)),
                       ("fro_scale_batch", (Xf,)),
                       ("sym_batch", (C,)),
                       ("sym_guard_batch", (C, kernels.sym_batch(C), X))):
        kernels.reset_launch_counts()
        got = getattr(kernels, name)(*args)
        torch.cuda.synchronize()
        assert kernels.launch_counts[f"{name}_{sfx}"] == 1
        want = getattr(kernels, name + "_plain")(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        _close([g for g in got if g.is_floating_point()],
               [w for w in want if w.is_floating_point()], dtype)
        for g, w in zip(got, want):
            if not g.is_floating_point():
                assert torch.equal(g, w), name
    kernels.reset_launch_counts()
    Xp, rank = polar_psd_batch(X, aggressive=7, polish=4)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["ns_gemm_batch"] == 30
    on_cpu = polar_psd_batch(X.cpu(), aggressive=7, polish=4)
    if B > 1:
        assert int(rank[1]) == side
        assert torch.equal(Xp[1].nan_to_num(7.0), X[1].nan_to_num(7.0))
    ok = torch.isfinite(X).all(dim=(1, 2)).cpu()
    err = (Xp.cpu()[ok] - on_cpu[0][ok]).abs().max() / X.cpu()[ok].abs().max()
    assert float(err) <= (1e-11 if dtype == torch.float64 else 2e-4)


def test_solve_batch_subspace_on_card_matches_cpu(cuda):
    """The f64 subspace program (subspace_mixed=False) at B = 8, side 40 on
    the card against its CPU plain run: the same reseed decisions and
    statuses, iterations within 2 %, objectives to 1e-6; K12 launches."""
    from proxsdp_tpu_torch.parallel.batch import BatchStats, solve_batch

    problems = [maxcut_problem(random_graph_weights(s, 40))[0]
                for s in range(8)]
    opts = tx.Options(tol_gap=1e-4, tol_feasibility=1e-4,
                      hybrid_precision=False, subspace_mixed=False)
    kernels.reset_launch_counts()
    st_gpu, st_cpu = BatchStats(), BatchStats()
    got = solve_batch(problems, opts, projection="subspace", stats=st_gpu)
    counts = kernels.kernel_launches()
    want = solve_batch(problems, opts, projection="subspace", device="cpu",
                       stats=st_cpu)
    assert [r[3:] for r in st_gpu.reseeds] == [r[3:] for r in st_cpu.reseeds]
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert abs(g.iter - w.iter) <= max(2, 0.02 * w.iter)
        assert abs(g.objval - w.objval) <= 1e-6 * (1 + abs(w.objval))
    assert counts["batched_subspace"] > 0


# ---------------------------------------------------------------- K11, K7


def _lanczos_input(n, kind, dtype, dev):
    """(X, v0, tol): a random symmetric X, a rank-8-plus-noise one, an
    exactly rank-10 one (beta breaks down; f32 at tol 1e-7, a breakdown
    threshold above f32 rounding), v0 = 0, and one NaN entry."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    A = 0.5 * (A + A.T)
    v0 = rng.standard_normal(n)
    tol = 1e-12
    if kind == "lowrank":
        Q, _ = np.linalg.qr(rng.standard_normal((n, 8)))
        A = (Q * np.linspace(50.0, 10.0, 8)) @ Q.T + 1e-3 * A
    elif kind == "rank10":
        Q, _ = np.linalg.qr(rng.standard_normal((n, 10)))
        A = (Q * np.arange(1.0, 11.0)) @ Q.T
        tol = 1e-7 if dtype == torch.float32 else tol
    elif kind == "v0_zero":
        v0 = np.zeros(n)
    elif kind == "nan":
        A[3, 5] = A[5, 3] = np.nan
    return (torch.tensor(A, dtype=dtype, device=dev),
            torch.tensor(v0, dtype=dtype, device=dev), tol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1100, 2000])
@pytest.mark.parametrize("kind", ["random", "lowrank", "rank10", "v0_zero",
                                  "nan"])
def test_lanczos_krylov_matches_plain(cuda, n, dtype, kind):
    """K11 and lanczos_topk on the card against the plain versions on the
    card: the 16 leading Ritz values within 1e-10 (f64) / 1e-4 (f32) of the
    largest, the residual test's decisions and ranks at target ranks 2, 8
    and 16 equal, alphas and betas within 1e-8 ||X||_F in f64."""
    from proxsdp_tpu_torch.ops import cones as tcones
    from proxsdp_tpu_torch.ops import lanczos as tlz

    ncv = tcones.lanczos_ncv(n, tx.Options())
    X, v0, tol = _lanczos_input(n, kind, dtype, cuda)
    kernels.reset_launch_counts()
    ga, gb, gV = kernels.lanczos_krylov(X, v0, ncv, tol)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["lanczos_krylov"] == 1
    pa, pb, pV = kernels.lanczos_krylov_plain(X, v0, ncv, tol)
    got = tlz.ritz_pairs(ga, gb, gV)
    want = tlz.ritz_pairs(pa, pb, pV, gemm=kernels.ns_gemm_plain)
    if kind == "nan":
        # V[0] is the (finite) start vector; everything after it is NaN
        assert all(bool(torch.isnan(t).all())
                   for t in (ga, gb, gV[1:], *got))
        return
    scale = float(want.vals.abs().max())
    tol_v = 1e-10 if dtype == torch.float64 else 1e-4
    assert float((got.vals[:16] - want.vals[:16]).abs().max()) <= tol_v * scale
    for tr in (2, 8, 16):
        dec = []
        for r in (got, want):
            v, res = r.vals[:tr], r.resid[:tr]
            ok = bool(torch.all(res <= torch.clamp_min(tol * v.abs(), 10 * tol)))
            dec.append((ok, int((v > 0).sum())))
        assert dec[0] == dec[1], (tr, dec)
    if dtype == torch.float64:
        fro = float(torch.linalg.norm(X))
        assert float((ga - pa).abs().max()) <= 1e-8 * fro
        assert float((gb - pb).abs().max()) <= 1e-8 * fro
    if kind == "rank10" and dtype == torch.float64:
        assert bool((gb[10:] == 0).any())  # the restart ran


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [192, 256])
def test_cholqr_wide_matches_plain(cuda, dtype, k):
    """K7 at the subspace buckets of a side-2000 solve: G in shared memory
    (f32, k = 192) or in the global scratch (the others)."""
    rng = np.random.default_rng(k)
    X = torch.tensor(rng.standard_normal((2000, 2000)), dtype=dtype, device=cuda)
    Y = torch.matmul(X, torch.tensor(rng.standard_normal((2000, k)),
                                     dtype=dtype, device=cuda))
    got = kernels.cholqr(Y)
    want = kernels.cholqr_plain(Y, kernels.CHOLQR_EPS[dtype])
    _close((got,), (want,), dtype)


def test_lanczos_solve_on_card_matches_cpu(cuda):
    """50 iterations of the f64 Lanczos program at side 1100 on the card
    and on the CPU from one init_state: the same accept decisions and
    target rank, the last iterate's scalars within 1e-8 relative."""
    problem, _ = maxcut_problem(random_graph_weights(0, 1100))
    setup = to_square_form(preprocess(problem))
    layout, opts = setup.layout, tx.Options(hybrid_precision=False)
    host = tsolver.init_state(layout, opts, setup)
    out = {}
    for dev in ("cpu", "cuda"):
        M = build_linop(setup.A, setup.G, torch.float64, device=dev)
        o = convert.operands_from_numpy(
            M=M, b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
            norm_h=setup.norm_h, norm_c=setup.norm_c,
            obj_scale=setup.obj_scale * setup.rhs_scale, device=dev)
        _, it, fetch = tsolver.make_chunk_runner(layout, opts, device=dev)
        s = convert.state_from_numpy(host, dev)
        kernels.reset_launch_counts()
        fb = []
        for k in range(50):
            p = int(s.proj_fallbacks)
            s = it(s, o, k)
            fb.append(int(s.proj_fallbacks) - p)
        out[dev] = (fb, fetch(s), kernels.kernel_launches()["lanczos_krylov"])
    (fb_g, got, n_g), (fb_w, want, n_w) = out["cuda"], out["cpu"]
    assert n_g == 50 and n_w == 0
    assert fb_g == fb_w
    assert got[9] == want[9]  # target rank
    np.testing.assert_allclose(got[2:9], want[2:9], rtol=1e-8)


# ---- K15 / K15b: the linesearch's trial loop in one launch, against the
# K2 -> M' product -> sq_dist sequence it replaces (the plain loops on the
# card launch those kernels and read one flag a trial)


class _OrderedDense:
    """A dense operator whose M' product adds the rows in order, a column
    at a time -- K15's dense order -- in separate elementwise launches."""

    def __init__(self, mat):
        self.mat = mat
        self.shape = tuple(mat.shape)

    def rmatvec(self, y):
        acc = self.mat[0] * y[0]
        for r in range(1, self.mat.shape[0]):
            acc = acc + self.mat[r] * y[r]
        return acc

    def rmatvec_batch(self, Y):
        acc = self.mat[0][None, :] * Y[:, :1]
        for r in range(1, self.mat.shape[0]):
            acc = acc + self.mat[r][None, :] * Y[:, r : r + 1]
        return acc


def _ls_operator(form, dtype, device, rng):
    """(operator for K15, operator for the sequence, p, m): max-cut at
    side 50 (ELL), a random sparse 40 x 300 matrix with a dense row and
    a dense column (COO), a dense 12 x 30 matrix with 4 inequality rows."""
    from proxsdp_tpu_torch.ops.linop import CooOp, DenseOp

    if form == "ell":
        setup = to_square_form(preprocess(maxcut_problem(
            random_graph_weights(0, 50))[0]))
        M = build_linop(setup.A, setup.G, dtype, device=device)
        return M, M, setup.layout.p, setup.layout.m
    if form == "coo":
        nr, nc = 40, 300
        mask = rng.random((nr, nc)) < 0.05
        mask[0, :] = True
        mask[:, 7] = True
        r, c = np.nonzero(mask)
        M = CooOp(r, c, rng.standard_normal(r.size), nr, nc, dtype=dtype,
                  device=device)
        return M, M, 30, 10
    mat = torch.tensor(rng.standard_normal((12, 30)), dtype=dtype,
                       device=device)
    return DenseOp(mat), _OrderedDense(mat), 8, 4


LS_CASES = {  # (step scale, max_linsearch_steps, y non-finite)
    "one": (0.05, 5000, False),
    "several": (8.0, 5000, False),
    "max_steps": (1e8, 4, False),
    "nonfinite": (1.0, 6, True),
}


def _ls_state(rng, M, p, m, scale, nonfinite, dtype, device, B=None):
    rows, n = p + m, M.shape[1]
    lead = () if B is None else (B,)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    y = rng.standard_normal(lead + (rows,))
    if nonfinite:
        y[..., 0] = np.nan
    y_old = rng.standard_normal(lead + (rows,))
    st = dict(y=t(y), Mx=t(rng.standard_normal(lead + (rows,))),
              Mx_old=t(rng.standard_normal(lead + (rows,))),
              b=t(rng.standard_normal(lead + (p,))),
              h=t(rng.standard_normal(lead + (m,))), y_old=t(y_old))
    sc = scale if B is None else scale * np.exp(rng.uniform(-1, 1, B))
    st.update(tau=t(sc), tau_old=t(0.9 * np.asarray(sc)),
              theta=t(np.full(lead, 0.7) if B else 0.7),
              beta=t(np.full(lead, 1.3) if B else 1.3))
    st["Mty"] = t(rng.standard_normal(lead + (n,)))
    return st


def _equal_or_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    if dtype == torch.float64:  # bit for bit (NaN where NaN)
        for g, w in zip(got, want):
            if g.is_floating_point():
                assert torch.equal(torch.isnan(g), torch.isnan(w))
                g, w = torch.nan_to_num(g, 7.0), torch.nan_to_num(w, 7.0)
            assert torch.equal(g, w)
        return
    for g, w in zip(got, want):  # K2's f32 bound
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
            continue
        g, w = g.double().cpu(), w.double().cpu()
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        err = torch.where(same, torch.zeros_like(g), (g - w).abs()).max()
        finite = w[torch.isfinite(w)]
        scale = finite.abs().max().clamp_min(1e-30) if finite.numel() else 1.0
        assert float(err / scale) <= 1e-7


@pytest.mark.parametrize("case", list(LS_CASES))
@pytest.mark.parametrize("form", ["ell", "coo", "dense"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_linesearch_loop_matches_sequence(cuda, dtype, form, case):
    """K15 against K2 -> the product (K1, K14, the ordered dense sum) ->
    sq_dist with one host read a trial: bit for bit in f64, within K2's
    f32 bound in f32; one launch of K15 and none of the others."""
    rng = np.random.default_rng(5)
    scale, steps, nonfinite = LS_CASES[case]
    M, M_seq, p, m = _ls_operator(form, dtype, cuda, rng)
    st = _ls_state(rng, M, p, m, scale, nonfinite, dtype, cuda)
    Mty_old = M_seq.rmatvec(st["y_old"]) + 1e-3 * st["Mty"]
    args = (st["y"], st["Mx"], st["Mx_old"], st["b"], st["h"], st["y_old"],
            Mty_old, st["tau"], st["tau_old"], st["theta"], st["beta"], p, m,
            0.9999, 0.75, steps)
    kernels.reset_launch_counts()
    got = kernels.linesearch_loop(M, *args)
    torch.cuda.synchronize()
    counts = kernels.kernel_launches()
    assert counts["linesearch_loop"] == 1 and sum(counts.values()) == 1
    want = kernels.linesearch_loop_plain(M_seq, *args)
    _equal_or_close(got, want, dtype)
    trials = int(got[4])
    if case == "one":
        assert trials == 1
    elif case == "several":
        assert 2 < trials < steps
    else:
        assert trials == steps


@pytest.mark.parametrize("B, side", [(1024, 16), (256, 40)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_linesearch_loop_batch_matches_sequence(cuda, dtype, B, side):
    """K15b at phase D's and G1's shapes (the shared ELL operator of the
    max-cut batch, per-instance step scales so that the instances take
    one to ~20 trials, a third of them inactive) against the batched K2 ->
    K1 -> sq_dist sequence: bit for bit in f64, within K2's f32 bound in
    f32; inactive instances keep their values."""
    from proxsdp_tpu_torch.parallel.batch import _batch_operands

    rng = np.random.default_rng(side)
    setups = [preprocess(maxcut_problem(random_graph_weights(s, side))[0])
              for s in range(B)]
    o = _batch_operands(setups, dtype, cuda, "auto")
    p, m = setups[0].layout.p, setups[0].layout.m
    st = _ls_state(rng, o.M, p, m, 2.0, False, dtype, cuda, B=B)
    st["b"], st["h"] = o.b, o.h
    Mty_old = o.M.rmatvec_batch(st["y_old"])
    active = torch.tensor(rng.random(B) > 1 / 3, device=cuda)
    args = (st["y"], st["Mx"], st["Mx_old"], st["b"], st["h"], st["y_old"],
            st["Mty"], Mty_old, st["tau"], st["tau_old"], st["theta"],
            st["beta"], active, p, m, 0.9999, 0.75, 5000)
    kernels.reset_launch_counts()
    got = kernels.linesearch_loop_batch(o.M, *args)
    torch.cuda.synchronize()
    counts = kernels.kernel_launches()
    assert counts["linesearch_loop_batch"] == 1 and sum(counts.values()) == 1
    want = kernels.linesearch_loop_batch_plain(o.M, *args)
    _equal_or_close(got, want, dtype)
    trials = got[4].cpu()
    a = active.cpu()
    assert int(trials[~a].abs().sum()) == 0
    assert int(trials[a].min()) >= 1 and int(trials[a].max()) > 2
    assert torch.equal(got[0][~active], st["y"][~active])
    assert torch.equal(got[3][~active], st["tau"][~active])


def test_linesearch_loop_batch_dense_matches_sequence(cuda):
    """K15b over a shared dense operator against the ordered dense sum."""
    rng = np.random.default_rng(9)
    M, M_seq, p, m = _ls_operator("dense", torch.float64, cuda, rng)
    B = 16
    st = _ls_state(rng, M, p, m, 3.0, False, torch.float64, cuda, B=B)
    Mty_old = M_seq.rmatvec_batch(st["y_old"])
    active = torch.tensor(rng.random(B) > 0.25, device=cuda)
    args = (st["y"], st["Mx"], st["Mx_old"], st["b"], st["h"], st["y_old"],
            st["Mty"], Mty_old, st["tau"], st["tau_old"], st["theta"],
            st["beta"], active, p, m, 0.9999, 0.75, 5000)
    got = kernels.linesearch_loop_batch(M, *args)
    want = kernels.linesearch_loop_batch_plain(M_seq, *args)
    _equal_or_close(got, want, torch.float64)


def test_solve_through_k15_equals_sequence(cuda, monkeypatch):
    """A side-50 Options(hybrid_precision=False) solve on the card through
    K15, and again with the linesearch as the K2 -> K1 -> sq_dist sequence
    (one host read a trial): the same iterations, bit-equal iterates."""
    problem, _ = maxcut_problem(random_graph_weights(0, 50))
    opts = tx.Options(hybrid_precision=False)
    kernels.reset_launch_counts()
    got = tx.solve(problem, opts)
    assert kernels.kernel_launches()["linesearch_loop"] >= got.iter
    monkeypatch.setattr(kernels, "linesearch_loop",
                        kernels.linesearch_loop_plain)
    kernels.reset_launch_counts()
    want = tx.solve(problem, opts)
    counts = kernels.kernel_launches()
    assert counts["linesearch_loop"] == 0 and counts["sq_dist"] >= want.iter
    assert got.status == want.status == 1
    assert got.iter == want.iter
    for name in ("primal", "dual_eq", "dual_in", "dual_cone"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.objval == want.objval


def test_linesearch_loop_rejects_bad_input(cuda):
    rng = np.random.default_rng(1)
    M, _, p, m = _ls_operator("dense", torch.float64, cuda, rng)
    st = _ls_state(rng, M, p, m, 1.0, False, torch.float64, cuda)
    args = [st["y"], st["Mx"], st["Mx_old"], st["b"], st["h"], st["y_old"],
            st["Mty"], st["tau"], st["tau_old"], st["theta"], st["beta"], p,
            m, 0.9999, 0.75]
    with pytest.raises(ValueError, match="max_steps"):
        kernels.linesearch_loop(M, *args, 0)
    args[3] = st["b"].float()
    with pytest.raises(TypeError):
        kernels.linesearch_loop(M, *args, 10)


# ---- per-instance operators in the batch: K16, K1b' and K15b'


def _randsdp_setups(B, side, m):
    from proxsdp_tpu_torch.models.randsdp import randsdp_problem

    return [preprocess(randsdp_problem(s, side, m, varbounds=False)[0])
            for s in range(B)]


def _scaled_maxcut_setups(B, side):
    import chip_smoke

    return [preprocess(p) for p in chip_smoke.k3_problems(
        tx.Optimizer, random_graph_weights, B, side)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B, R, n", [(64, 20, 820), (3, 37, 1000), (5, 1, 7)])
def test_batched_gemv_matches_plain(cuda, dtype, B, R, n):
    """K16 in both directions (phase K1's shape and ragged ones) against
    its plain versions (cuBLAS batched products: RTOL); M' y equals the
    rows summed in order, K15b''s dense order, bit for bit; one launch
    each."""
    rng = np.random.default_rng(B + R + n)
    M = torch.tensor(rng.standard_normal((B, R, n)), dtype=dtype, device=cuda)
    x = torch.tensor(rng.standard_normal((B, n)), dtype=dtype, device=cuda)
    y = torch.tensor(rng.standard_normal((B, R)), dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    got, got_t = kernels.batched_gemv(M, x), kernels.batched_gemv_t(M, y)
    torch.cuda.synchronize()
    counts = kernels.kernel_launches()
    assert counts["batched_gemv"] == counts["batched_gemv_t"] == 1
    assert got.shape == (B, R) and got_t.shape == (B, n)
    _close((got,), (kernels.batched_gemv_plain(M, x),), dtype)
    _close((got_t,), (kernels.batched_gemv_t_plain(M, y),), dtype)
    acc = torch.zeros(B, n, dtype=dtype, device=cuda)
    for r in range(R):
        acc = acc + M[:, r, :] * y[:, r:r + 1]
    assert torch.equal(got_t, acc)
    with pytest.raises(ValueError):
        kernels.batched_gemv(M, y)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ell_spmv_batch_per_instance_matches_plain(cuda, dtype):
    """K1b' over the stacked per-instance ELL values of a scaled max-cut
    sweep (phase K3's operator), both directions, bit for bit its plain
    version; each launch also counts as a per-instance launch.  With one
    instance's values repeated B times it equals the shared product."""
    from proxsdp_tpu_torch.parallel.batch import _batch_operands

    B = 64
    o = _batch_operands(_scaled_maxcut_setups(B, 40), dtype, cuda, "auto")
    E = o.M
    assert E.batched
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((B, E.shape[1])), dtype=dtype,
                     device=cuda)
    y = torch.tensor(rng.standard_normal((B, E.shape[0])), dtype=dtype,
                     device=cuda)
    kernels.reset_launch_counts()
    got = (E.matvec_batch(x), E.rmatvec_batch(y))
    torch.cuda.synchronize()
    assert kernels.launch_counts[f"ell_spmv_batch_{kernels._SUFFIX[dtype]}"] \
        == kernels.per_instance_launches[
            f"ell_spmv_batch_{kernels._SUFFIX[dtype]}"] == 2
    want = (kernels.ell_spmv_batch_plain(E.row_cols, E.row_vals, x),
            kernels.ell_spmv_batch_plain(E.col_rows, E.col_vals, y))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    same = kernels.ell_spmv_batch(E.row_cols,
                                  E.row_vals[:1].expand_as(E.row_vals)
                                  .contiguous(), x)
    assert torch.equal(same, kernels.ell_spmv_batch(E.row_cols, E.row_vals[0],
                                                    x))


@pytest.mark.parametrize("form", ["ell", "dense"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_linesearch_loop_batch_per_instance_matches_sequence(cuda, dtype,
                                                             form):
    """K15b' over per-instance operators -- the scaled max-cut's stacked
    ELL values (B = 64, side 40), randsdp's stacked dense matrices (B = 16,
    side 10) -- against the batched K2 -> M' product (K1b', K16's M' y) ->
    sq_dist sequence: bit for bit in f64, within K2's f32 bound in f32; a
    third of the instances inactive."""
    from proxsdp_tpu_torch.parallel.batch import _batch_operands, operator_kind

    setups = (_scaled_maxcut_setups(64, 40) if form == "ell"
              else _randsdp_setups(16, 10, 5))
    B = len(setups)
    o = _batch_operands(setups, dtype, cuda, "auto")
    assert operator_kind(o.M) == ("ell_batched" if form == "ell"
                                  else "dense_batched")
    rng = np.random.default_rng(11)
    p, m = setups[0].layout.p, setups[0].layout.m
    st = _ls_state(rng, o.M, p, m, 2.0, False, dtype, cuda, B=B)
    Mty_old = o.M.rmatvec_batch(st["y_old"])
    active = torch.tensor(rng.random(B) > 1 / 3, device=cuda)
    args = (st["y"], st["Mx"], st["Mx_old"], o.b, o.h,
            st["y_old"], st["Mty"], Mty_old, st["tau"], st["tau_old"],
            st["theta"], st["beta"], active, p, m, 0.9999, 0.75, 5000)
    kernels.reset_launch_counts()
    got = kernels.linesearch_loop_batch(o.M, *args)
    torch.cuda.synchronize()
    sfx = kernels._SUFFIX[dtype]
    assert kernels.per_instance_launches[f"linesearch_loop_batch_{sfx}"] == 1
    assert sum(kernels.launch_counts.values()) == 1
    want = kernels.linesearch_loop_batch_plain(o.M, *args)
    _equal_or_close(got, want, dtype)
    trials = got[4].cpu()
    assert int(trials[~active.cpu()].abs().sum()) == 0
    assert int(trials[active.cpu()].max()) > 1


def test_solve_batch_per_instance_on_card_matches_cpu(cuda):
    """solve_batch of per-instance sweeps on the card against the CPU
    plain run, f64 program: randsdp (dense_batched, K16 and K15b') and the
    scaled max-cut (ell_batched, K1b' and K15b'): the same statuses,
    iterations within 2 %, objectives to 1e-6."""
    from proxsdp_tpu_torch.models.randsdp import randsdp_problem
    from proxsdp_tpu_torch.parallel.batch import solve_batch
    import chip_smoke

    opts = tx.Options(tol_gap=1e-4, tol_feasibility=1e-4,
                      hybrid_precision=False)
    for problems, kind in (
            ([randsdp_problem(s, 10, 5, varbounds=False)[0] for s in range(8)],
             "dense"),
            (chip_smoke.k3_problems(tx.Optimizer, random_graph_weights, 16, 16),
             "ell")):
        kernels.reset_launch_counts()
        got = solve_batch(problems, opts, projection="eigh")
        counts = dict(kernels.launch_counts)
        per = dict(kernels.per_instance_launches)
        want = solve_batch(problems, opts, projection="eigh", device="cpu")
        for g, w in zip(got, want):
            assert g.status == w.status == 1
            assert abs(g.iter - w.iter) <= max(2, 0.02 * w.iter)
            assert abs(g.objval - w.objval) <= 1e-6 * (1 + abs(w.objval))
        assert per["linesearch_loop_batch_f64"] > 0
        if kind == "dense":
            assert counts["batched_gemv_f64"] > 0
        else:
            assert per["ell_spmv_batch_f64"] > 0


@pytest.mark.parametrize("case", ["eigh", "polar"])
def test_solve_batch_large_on_card_matches_cpu(cuda, case):
    """solve_batch's f64 program at side 130 (B = 3) on the card -- the
    eigh mode on K9L, or Options(projection="polar") on K5b and K6b --
    against the same program on the CPU: statuses and iterations equal,
    objectives within 1e-8 relative."""
    from proxsdp_tpu_torch.parallel.batch import solve_batch

    problems = [maxcut_problem(random_graph_weights(s, 130))[0]
                for s in range(3)]
    opts = tx.Options(tol_gap=1e-4, tol_feasibility=1e-4,
                      hybrid_precision=False, projection=case)
    kernels.reset_launch_counts()
    got = solve_batch(problems, opts, projection="eigh")
    counts = kernels.kernel_launches()
    want = solve_batch(problems, opts, projection="eigh", device="cpu")
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert g.iter == w.iter
        assert abs(g.objval - w.objval) <= 1e-8 * (1 + abs(w.objval))
    if case == "eigh":
        assert counts["batched_psd_eigh_large"] > 0
    else:
        assert counts["ns_gemm_batch"] > 0 and counts["sym_guard_batch"] > 0
        assert counts["batched_psd_eigh_large"] == 0


# ---- the batch over any cone layout: K13b, K14b and K15b's COO form


@pytest.mark.parametrize("nblk", [128, 4096])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_soc_projection_batch_matches_rows(cuda, dtype, nblk):
    """K13b on B = 7 rows (a column slice of a wider iterate, as the batch
    passes it) against K13 on each row and the plain version, bit for
    bit; one launch."""
    rng = np.random.default_rng(nblk + 1)
    rows = [soc_inputs(rng, nblk, dtype, cuda) for _ in range(7)]
    lens = rows[0][1]
    wide = torch.zeros(7, 3 + rows[0][0].numel() + 5, dtype=dtype, device=cuda)
    wide[:, 3:-5] = torch.stack([v for v, _ in rows])
    V = wide[:, 3:-5]
    kernels.reset_launch_counts()
    got, gap = kernels.soc_projection_batch(V, lens)
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["soc_projection_batch"] == 1
    for i in range(7):
        one, g1 = kernels.soc_projection(V[i].contiguous(), lens)
        assert torch.equal(got[i], one) and torch.equal(gap[i], g1)
    want, wgap = kernels.soc_projection_batch_plain(V, lens)
    assert torch.equal(got, want) and torch.equal(gap, wgap)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_coo_spmv_batch_matches_rows(cuda, dtype):
    """K14b on B = 11 rows (two groups of eight rows, the second short)
    over test_coo_spmv_matches_plain's operator: each row K14's bit for
    bit, the plain version within RTOL; a repeat gives the same bits."""
    import scipy.sparse as sp

    rng = np.random.default_rng(16)
    side, m, B = 60, 2500, 11
    n = side * side
    rows = np.concatenate([np.zeros(side, np.int64), 1 + np.arange(m)])
    cols = np.concatenate([np.arange(side) * (side + 1),
                           rng.choice(n, m, replace=False)])
    A = sp.csr_matrix((rng.standard_normal(side + m), (rows, cols)),
                      shape=(m + 1, n))
    M = build_linop(A, sp.csr_matrix((0, n)), dtype, device=cuda)
    assert type(M).__name__ == "CooOp"
    X = torch.tensor(rng.standard_normal((B, n)), dtype=dtype, device=cuda)
    Y = torch.tensor(rng.standard_normal((B, m + 1)), dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    got = (M.matvec_batch(X), M.rmatvec_batch(Y))
    torch.cuda.synchronize()
    assert kernels.kernel_launches()["coo_spmv_batch"] == 2
    for i in range(B):
        assert torch.equal(got[0][i], M.matvec(X[i]))
        assert torch.equal(got[1][i], M.rmatvec(Y[i]))
    want = (kernels.coo_spmv_batch_plain(M.row_ptr, M.row_idx, M.row_vals, X,
                                         M.row_seg),
            kernels.coo_spmv_batch_plain(M.col_ptr, M.col_idx, M.col_vals, Y,
                                         M.col_seg))
    _close(got, want, dtype)
    assert torch.equal(M.matvec_batch(X), got[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_linesearch_loop_batch_coo_matches_sequence(cuda, dtype):
    """K15b's COO form over _ls_operator's COO operator, B = 9 with
    per-instance step scales and a third inactive, against the batched K2
    -> K14b -> sq_dist sequence: bit for bit in f64, within K2's f32 bound
    in f32; inactive instances keep their values."""
    rng = np.random.default_rng(17)
    M, _, p, m = _ls_operator("coo", dtype, cuda, rng)
    B = 9
    st = _ls_state(rng, M, p, m, 4.0, False, dtype, cuda, B=B)
    Mty_old = M.rmatvec_batch(st["y_old"])
    active = torch.tensor(np.arange(B) % 3 != 1, device=cuda)
    args = (st["y"], st["Mx"], st["Mx_old"], st["b"], st["h"], st["y_old"],
            st["Mty"], Mty_old, st["tau"], st["tau_old"], st["theta"],
            st["beta"], active, p, m, 0.9999, 0.75, 5000)
    kernels.reset_launch_counts()
    got = kernels.linesearch_loop_batch(M, *args)
    torch.cuda.synchronize()
    counts = kernels.kernel_launches()
    assert counts["linesearch_loop_batch"] == 1 and sum(counts.values()) == 1
    want = kernels.linesearch_loop_batch_plain(M, *args)
    _equal_or_close(got, want, dtype)
    trials = got[4].cpu()
    assert int(trials[~active.cpu()].abs().sum()) == 0
    assert int(trials[active.cpu()].max()) > 1
    assert torch.equal(got[0][~active], st["y"][~active])


@pytest.mark.parametrize("linop", ["auto", "coo"])
def test_solve_batch_layouts_on_card_matches_cpu(cuda, linop):
    """solve_batch's f64 program over chip_smoke.py's conic sweep at a
    small size (PSD blocks of sides 4, 4 and 9, SOC blocks of 3, 5 and 5,
    6 LP coordinates, 20 rows; B = 4) on the card against the CPU plain
    run: the same statuses, iterations within 2 %, objectives to 1e-6 (as
    test_solve_batch_per_instance_on_card_matches_cpu); K9, K13b and,
    under linop="coo", K14b on the path."""
    from proxsdp_tpu_torch.parallel.batch import solve_batch
    import chip_smoke

    data = chip_smoke.conic_program_data(sides=(4, 4, 9), soc_lens=(3, 5, 5),
                                         n_lp=6, rows=20, density=0.3)
    problems = [chip_smoke.build_conic_program(
        tx, chip_smoke.conic_sweep_instance(data, s))[0] for s in range(4)]
    opts = tx.Options(tol_gap=1e-4, tol_feasibility=1e-4,
                      hybrid_precision=False, linop=linop)
    kernels.reset_launch_counts()
    got = solve_batch(problems, opts)
    counts = kernels.kernel_launches()
    want = solve_batch(problems, opts, device="cpu")
    for g, w in zip(got, want):
        assert g.status == w.status == 1
        assert abs(g.iter - w.iter) <= max(2, 0.02 * w.iter)
        assert abs(g.objval - w.objval) <= 1e-6 * (1 + abs(w.objval))
    assert counts["batched_psd_eigh"] > 0
    assert counts["soc_projection_batch"] > 0
    assert (counts["coo_spmv_batch"] > 0) == (linop == "coo")


def _sign_inputs(rng, side, k, dev, case):
    """Q, Z of one sign step: X with k // 2 positive eigenvalues, Q the
    CholeskyQR2 basis of X times its top-k eigenvectors (plus noise where
    ``unconverged``), Z = X Q; a zero column of Q (``rank_deficient``) or
    a NaN in Z (``nan``)."""
    U = torch.linalg.qr(torch.tensor(rng.standard_normal((side, side)),
                                     device=dev)).Q
    w = np.concatenate([np.linspace(40.0, 1.0, k // 2),
                        -np.linspace(0.05, 5.0, side - k // 2)])
    X = ((U * torch.tensor(w, device=dev)) @ U.T).float()
    warm = U[:, :k].float()
    if case == "unconverged":
        warm = warm + 0.3 * torch.tensor(rng.standard_normal((side, k)),
                                         dtype=torch.float32, device=dev)
    Q = kernels.cholqr_plain(kernels.cholqr_plain(X @ warm, 1e-6), 1e-6)
    if case == "rank_deficient":
        Q[:, k // 3] = 0.0
    Z = X @ Q
    if case == "nan":
        Z[3, 1] = float("nan")
    return Q.contiguous(), Z.contiguous()


@pytest.mark.parametrize("case", ["converged", "unconverged",
                                  "rank_deficient", "nan"])
@pytest.mark.parametrize("side, k", [(250, 16), (250, 24), (100, 64),
                                     (300, 96), (500, 128)])
def test_subspace_sign_matches_plain(cuda, side, k, case):
    """K17 against its plain twin on the card: Bp and the statistics
    within 1e-5 of their scale (f32 products in other orders through ~30
    dependent k x k products), the flags equal; both sides of the shared
    memory limit (k = 64 and 96)."""
    rng = np.random.default_rng(side + k)
    Q, Z = _sign_inputs(rng, side, k, cuda, case)
    at = torch.tensor(1e-4, dtype=torch.float32, device=cuda)
    kernels.reset_launch_counts()
    got = kernels.subspace_sign(Q, Z, at, 1e-9, 7, 4, False)
    torch.cuda.synchronize()
    assert kernels.launch_counts["subspace_sign_f32"] == 1
    want = kernels.subspace_sign_plain(Q, Z, at, 1e-9, 7, 4, False)
    assert torch.equal(got[2].cpu(), want[2].cpu())
    g = torch.cat([got[0].reshape(-1), got[1]]).double().cpu()
    w = torch.cat([want[0].reshape(-1), want[1]]).double().cpu()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    fin = torch.isfinite(w)
    if bool(fin.any()):
        scale = float(w[fin].abs().max())
        assert float((g[fin] - w[fin]).abs().max()) <= 1e-5 * scale
    # force_full rejects; no accept_tol leaves subspace_tol alone
    forced = kernels.subspace_sign(Q, Z, None, 1e-9, 7, 4, True)
    assert int(forced[2][0]) == 0


def test_subspace_sign_rejects_bad_input(cuda):
    Q = torch.zeros(40, 8, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="f32 only"):
        kernels.subspace_sign(Q, Q, None, 1e-9, 7, 4, False)
    Q = torch.zeros(600, 264, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="k = 264"):
        kernels.subspace_sign(Q, Q, None, 1e-9, 7, 4, False)


@pytest.mark.parametrize("case", ["packed", "sign", "accept_always",
                                  "accept_always_packed"])
def test_single_solve_options_on_card_match_cpu(cuda, case):
    """The single solve's options at side 40 on the card against the CPU
    plain run: the f64 programs (the packed layout, the accept-always step
    with an f64 basis) the same status and iterations and objectives to
    1e-6; the sign-based f32 program the same status, its objective within
    1e-3 (1 + |obj|) (f32 products in other orders move the accepts), and
    K17 on the path; K10, K12 on theirs."""
    problem = maxcut_problem(random_graph_weights(3, 40))[0]
    opts = {
        "packed": tx.Options(hybrid_precision=False, square_form=False),
        "sign": tx.Options(dtype="float32", hybrid_precision=False,
                           subspace_rank=12, subspace_sign=True,
                           subspace_fallback="polar", tol_gap=1e-3,
                           tol_feasibility=1e-3),
        "accept_always": tx.Options(hybrid_precision=False, subspace_rank=8,
                                    subspace_accept_always=True,
                                    subspace_mixed=False),
        "accept_always_packed": tx.Options(
            hybrid_precision=False, subspace_rank=8, square_form=False,
            subspace_accept_always=True, subspace_mixed=False),
    }[case]
    kernels.reset_launch_counts()
    got = tx.solve(problem, opts)
    counts = kernels.kernel_launches()
    want = tx.solve(problem, opts, device="cpu")
    assert got.status == want.status == 1
    if case == "sign":
        assert abs(got.objval - want.objval) <= 1e-3 * (1 + abs(want.objval))
        assert counts["subspace_sign"] > 0
        return
    assert abs(got.iter - want.iter) <= max(2, 0.02 * want.iter)
    assert abs(got.objval - want.objval) <= 1e-6 * (1 + abs(want.objval))
    k10 = counts["tri_to_square"] + counts["square_to_tri"]
    # K10 unpacks the packed dense-eigh step's block and packs a square
    # block for K12, which reads a packed block as it is
    assert (k10 > 0) == (case in ("packed", "accept_always"))
    if case.startswith("accept_always"):
        assert counts["batched_subspace"] == got.iter
        assert counts["ritz_accept"] == 0


def test_checkpoint_on_card_resumes_on_cpu(cuda, tmp_path):
    """A checkpoint of the f64 program written on the card resumes on the
    CPU and on the card alike: status 1, the same iterations, objectives
    to 1e-8."""
    problem = maxcut_problem(random_graph_weights(0, 30))[0]
    path = str(tmp_path / "card.npz")
    r1 = tx.solve(problem, tx.Options(hybrid_precision=False,
                                      checkpoint_path=path, checkpoint_freq=40,
                                      max_iter=40, chunk_iters=40))
    assert r1.status == 3
    on_card = tx.solve(problem, tx.Options(hybrid_precision=False),
                       resume_from=path)
    on_cpu = tx.solve(problem, tx.Options(hybrid_precision=False),
                      resume_from=path, device="cpu")
    assert on_card.status == on_cpu.status == 1
    assert abs(on_card.iter - on_cpu.iter) <= 2
    assert abs(on_card.objval - on_cpu.objval) <= 1e-8 * (1 + abs(on_cpu.objval))


def _fill_free_memory_with_nan():
    """Hand the caching allocator's free blocks back full of NaN, as a
    long run leaves them after a NaN guard fired."""
    ts = [torch.full((nbytes // 8,), float("nan"), dtype=torch.float64,
                     device="cuda")
          for nbytes in [512 * 2 ** k for k in range(12)] * 20]
    ts.append(torch.full((2 ** 26,), float("nan"), dtype=torch.float64,
                         device="cuda"))
    del ts


@pytest.mark.parametrize("side", [4, 40, 250])
def test_eigh_of_zero_after_nan_memory(cuda, side):
    """The cold start's first projection is of an exact 0: cuSOLVER leaves
    its outputs unwritten there, so the port's eigh gives LAPACK's w = 0,
    V = I whatever the freed memory held (ops.cones._eigh and the batched
    plain version)."""
    from proxsdp_tpu_torch.ops.cones import _eigh

    eye = torch.eye(side, dtype=torch.float64, device=cuda)
    _fill_free_memory_with_nan()
    w, V = _eigh(torch.zeros(side, side, dtype=torch.float64, device=cuda))
    assert torch.equal(w, torch.zeros_like(w)) and torch.equal(V, eye)
    X = torch.zeros(3, side, side, dtype=torch.float64, device=cuda)
    X[1] = 2.0 * eye
    _fill_free_memory_with_nan()
    w, V = kernels._eigh_rows(X)
    assert torch.equal(w[0], torch.zeros_like(w[0])) and torch.equal(V[0], eye)
    assert torch.equal(w[2], w[0]) and torch.isfinite(V).all()


@pytest.mark.parametrize("square_form", [True, False])
def test_f64_program_after_nan_memory(cuda, square_form):
    """The f64 dense-eigh program at side 40, with the freed memory full
    of NaN before every iteration, repeats its CPU run for 40 iterations
    (to 1e-9 of each field's scale)."""
    problem = maxcut_problem(random_graph_weights(3, 40))[0]
    setup = preprocess(problem)
    if square_form:
        setup = to_square_form(setup)
    opts = tx.Options(hybrid_precision=False, square_form=square_form)
    states, its = {}, {}
    for dev in ("cpu", cuda):
        o = convert.operands_from_numpy(
            M=build_linop(setup.A, setup.G, torch.float64, device=dev),
            b=setup.b, h=setup.h, c=setup.c, norm_b=setup.norm_b,
            norm_h=setup.norm_h, norm_c=setup.norm_c,
            obj_scale=setup.obj_scale * setup.rhs_scale, device=dev)
        its[str(dev)] = (tsolver.make_chunk_runner(setup.layout, opts,
                                                   device=dev)[1], o)
        states[str(dev)] = convert.state_from_numpy(
            tsolver.init_state(setup.layout, opts, setup), dev)
    for k in range(40):
        _fill_free_memory_with_nan()
        for dev, (it, o) in its.items():
            states[dev] = it(states[dev], o, k)
    a = convert.state_to_numpy(states["cpu"])
    b = convert.state_to_numpy(states[str(cuda)])
    for name in ("x", "y", "Mx", "Mty", "min_eig"):
        scale = max(float(np.abs(a[name]).max()), 1.0)
        assert np.isfinite(b[name]).all(), name
        assert float(np.abs(a[name] - b[name]).max()) <= 1e-9 * scale, name


@pytest.mark.parametrize("side", [5, 50, 250])
@pytest.mark.parametrize("pair", ["f64", "f32", "f64_f32"])
def test_psd_reconstruct_matches_plain(cuda, side, pair):
    """K18 against its twin (max |err| within 1e-13 (f64) or 1e-6 of
    ||Xp||_F), and its row slabs of 2 and 3 ranks the rows of its whole
    product bit for bit."""
    from proxsdp_tpu_torch.parallel.dist import split

    dt = torch.float32 if pair == "f32" else torch.float64
    out = torch.float64 if pair == "f64" else torch.float32
    rng = np.random.default_rng(side)
    A = rng.standard_normal((side, side))
    w, V = torch.linalg.eigh(torch.tensor(A + A.T, dtype=dt, device=cuda))
    kernels.reset_launch_counts()
    full = kernels.psd_reconstruct(V, w, 0, side, out)
    assert kernels.kernel_launches()["psd_reconstruct"] == 1
    want = kernels.psd_reconstruct_plain(V, w, 0, side, out)
    assert full.dtype == out
    fro = float(torch.linalg.norm(want.double()))
    err = float((full.double() - want.double()).abs().max())
    assert err <= (1e-13 if pair == "f64" else 1e-6) * fro, err / fro
    for parts in (2, 3):
        slabs = [kernels.psd_reconstruct(V, w, lo, hi, out)
                 for lo, hi in split(side, parts)]
        assert torch.equal(torch.cat(slabs), full)


def _sharded_job(mesh):
    """A rank of test_sharded_solves_on_card: solve_sharded of a side-40
    max-cut under the default Options(), and solve_batch of 8 side-10
    instances over an axis named "batch" of the same ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    from proxsdp_tpu_torch.parallel.sharded import solve_sharded

    problem, _ = maxcut_problem(random_graph_weights(0, 40))
    res = solve_sharded(problem, mesh, tx.Options())
    bmesh = DeviceMesh(mesh.device_type, mesh.mesh.tolist(),
                       mesh_dim_names=("batch",))
    batch = tx.solve_batch([maxcut_problem(random_graph_weights(s, 10))[0]
                            for s in range(8)],
                           tx.Options(hybrid_precision=False), mesh=bmesh)
    return res.status, res.objval, [(r.status, r.objval) for r in batch]


def test_sharded_solves_on_card(cuda):
    """Two ranks sharing the card over gloo: the tensor-parallel default
    solve at the unsharded card solve's answer (1e-4 (1 + |obj|)), the
    mesh batch at the unsharded card batch's (1e-9), on both ranks."""
    from proxsdp_tpu_torch.parallel.dist import spawn

    outs = spawn(_sharded_job, 2, device_type="cuda", backend="gloo",
                 threads=0)
    problem, _ = maxcut_problem(random_graph_weights(0, 40))
    want = tx.solve(problem, tx.Options())
    batch = tx.solve_batch([maxcut_problem(random_graph_weights(s, 10))[0]
                            for s in range(8)],
                           tx.Options(hybrid_precision=False))
    assert outs[0] == outs[1]
    st, obj, got = outs[0]
    assert st == want.status == 1
    assert abs(obj - want.objval) <= 1e-4 * (1 + abs(want.objval))
    for (s, o), r in zip(got, batch):
        assert s == r.status == 1 and abs(o - r.objval) <= 1e-9


# ------------------------------------------- K19, K20, K21: the control


def _control_program():
    """A PSD block of side 4, an SOC block, equality and inequality rows
    (every row kind K19 and K20a read)."""
    o = tx.Optimizer()
    X = o.add_psd_var(4)
    sv = o.add_soc_var(3)
    for i in range(4):
        o.add_eq_constraint({int(X[i, i]): 1.0}, 1.0)
    o.add_eq_constraint({int(sv[0]): 1.0}, 2.0)
    o.add_ineq_constraint({int(X[0, 1]): 1.0}, 0.3)
    o.add_ineq_constraint({int(X[1, 2]): 1.0, int(sv[1]): 1.0}, 0.2)
    W = np.arange(16.0).reshape(4, 4)
    obj = o.psd_inner_product_coeffs(X, (W + W.T) / 10.0)
    obj[int(sv[2])] = 0.5
    o.set_objective(obj)
    return o.build_problem()


def _card_operands(setup, dtype, dev, B=None):
    import dataclasses

    o = convert.operands_from_numpy(
        M=build_linop(setup.A, setup.G, dtype, device=dev), b=setup.b,
        h=setup.h, c=setup.c, norm_b=setup.norm_b, norm_h=setup.norm_h,
        norm_c=setup.norm_c, obj_scale=setup.obj_scale * setup.rhs_scale,
        device=dev, dtype=dtype)
    if B is None:
        return o
    return dataclasses.replace(o, **{f: getattr(o, f).expand(
        (B,) + getattr(o, f).shape).contiguous() for f in (
        "b", "h", "c", "norm_b", "norm_h", "norm_c", "obj_scale")})


def _bits_equal(got, want):
    for g, w in zip(got, want):
        g, w = g.double().reshape(-1), w.double().reshape(-1)
        assert bool(((g == w) | (g.isnan() & w.isnan())).all())


def _flat(upd, stalled, wsum):
    out = [upd[k] for k in sorted(upd)]
    if stalled is not None:
        out += [stalled.to(torch.int32), wsum]
    return out


def _check_control(s, o, layout, opts, sides, r_k=None, r_p=None):
    """K20a within 1e-15 / 1e-6 (averages), K19 and K20b bit for bit
    against their twins on the same inputs; the kernels' new state."""
    dt = s.x.dtype
    p, m = layout.p, layout.m
    cfg = kernels.control_config(layout, opts)
    a_args = (s.x, s.y, s.Mx, s.Mty, s.avg_x, s.avg_y, s.avg_Mx, s.avg_Mty,
              s.avg_w, s.primal_step, o.c, o.b, o.h)
    got_a = kernels.restart_average(*a_args, p, m)
    want_a = kernels.restart_average_plain(*a_args, p, m)
    tol = 1e-15 if dt == torch.float64 else 1e-6
    for g, w in zip(got_a[:4], want_a[:4]):
        scale = w.double().abs().max().clamp_min(1e-300)
        assert float((g - w).double().abs().max() / scale) <= tol
    batched = s.x.dim() == 2
    red = got_a[4] if batched else torch.cat(
        [got_a[4][:, :3].sum(0), got_a[4][:, 3:].amax(0)])
    # each reduction against its sum of |terms| (its largest |value| for
    # a maximum): the kernel sums exact f64 products, the twin in dt
    wsum = torch.clamp_min(s.avg_w + s.primal_step, 1e-30).unsqueeze(-1)
    xa, ya, mxa = (v / wsum for v in want_a[:3])
    scale = torch.stack([
        (o.c.abs() * xa.abs()).sum(-1),
        (o.b.abs() * ya[..., :p].abs()).sum(-1),
        (o.h.abs() * ya[..., p:].abs()).sum(-1),
        (mxa[..., :p] - o.b).abs().amax(-1),
        (mxa[..., p:] - o.h).abs().amax(-1) if m else wsum[..., 0],
    ], dim=-1).double().clamp_min(1e-300)
    used = [0] + [1, 3] * bool(p) + [2, 4] * bool(m)  # read by K19
    err = (red - want_a[4].double()).abs() / scale
    assert float(err[..., used].max()) <= tol
    red = red.to(dt)
    got = kernels.control(s, o, cfg, sides, r=r_k,
                          red=red.double().reshape(-1, 5))
    want = kernels.control_plain(s, o, cfg, sides, r=r_p, red=red)
    _bits_equal(_flat(*got), _flat(*want))
    upd, stalled, wsum = got
    b_args = (s.x, s.y, s.Mx, s.Mty, *got_a[:4])
    _bits_equal(kernels.restart_adopt(*b_args, stalled, wsum),
                kernels.restart_adopt_plain(*b_args, stalled.bool(), wsum))
    return s.replace(**upd)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_control_kernels_match_plain_on_branch_states(cuda, dtype):
    """Every crafted branch state of kernels.control_cases, single and
    (the default options' ones) as a batch."""
    from proxsdp_tpu_torch.kernels import control_cases

    name = "float64" if dtype == torch.float64 else "float32"
    opts = tx.Options(hybrid_precision=False, dtype=name)
    for square in (True, False):
        setup = preprocess(_control_program())
        if square:
            setup = to_square_form(setup)
        layout = setup.layout
        sides = torch.tensor(layout.sdp_sides, dtype=torch.int32, device=cuda)
        cases = control_cases.branch_cases(
            tsolver.init_state(layout, opts, setup), opts, setup.c, setup.b,
            setup.h)
        if square:
            o = _card_operands(setup, dtype, cuda)
            for c in cases:
                s = convert.state_from_numpy(c.state, cuda)
                new = _check_control(s, o, layout, c.opts, sides)
                assert c.fired(c.state, convert.state_to_numpy(new)), c.name
        else:
            same = [c for c in cases if c.opts == opts]
            st = convert.state_from_numpy(convert.stack_states(
                [c.state for c in same]), cuda)
            o = _card_operands(setup, dtype, cuda, B=len(same))
            new = convert.state_to_numpy(_check_control(st, o, layout, opts,
                                                        sides))
            for i, c in enumerate(same):
                assert c.fired(c.state, convert.index_state(new, i)), c.name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_control_folds_k3_partials_bit_for_bit(cuda, dtype):
    """K19 fed K3's pass-1 partials (the iteration's path) gives what the
    twin gives on K3's own second pass, bit for bit; _scalar_step is four
    launches (K3, K20a, K19, K20b), the batch's as well."""
    problem, _ = maxcut_problem(random_graph_weights(0, 60))
    name = "float64" if dtype == torch.float64 else "float32"
    opts = tx.Options(hybrid_precision=False, dtype=name)
    for square in (True, False):
        setup = preprocess(problem)
        if square:
            setup = to_square_form(setup)
        layout = setup.layout
        host = tsolver.init_state(layout, opts, setup)
        rng = np.random.default_rng(3)
        for f in ("x", "x_old", "y", "y_old", "Mx", "Mx_old", "Mty",
                  "Mty_old", "avg_x", "avg_y", "avg_Mx", "avg_Mty"):
            host[f] = rng.standard_normal(host[f].shape).astype(host[f].dtype)
        B = None if square else 5
        if B:
            host = convert.stack_states([host] * B)
        s = convert.state_from_numpy(host, cuda)
        o = _card_operands(setup, dtype, cuda, B=B)
        sides = torch.tensor(layout.sdp_sides, dtype=torch.int32, device=cuda)
        args = (s.x, s.x_old, s.Mty, s.Mty_old, s.primal_step, s.y, s.y_old,
                s.Mx, s.Mx_old, s.dual_step, o.b, o.h, o.c, layout.p,
                layout.m)
        if square:
            r_k = kernels.residuals(*args, layout.sdp_sides, fold=False)
            r_p = kernels.residuals(*args, layout.sdp_sides)
            assert r_k.shape[0] > 1
        else:
            r_k = r_p = kernels.residuals_batch(*args)
        s1 = s.replace(x_old=s.x, y_old=s.y, Mty_old=s.Mty, Mx_old=s.Mx)
        _check_control(s1, o, layout, opts, sides, r_k=r_k, r_p=r_p)
        kernels.reset_launch_counts()
        step = kernels.ControlStep(kernels.control_config(layout, opts), sides)
        for _ in range(2):  # the call that makes the step's plans, and one after
            kernels.reset_launch_counts()
            tsolver._scalar_step(s, o, layout, opts, step)
            torch.cuda.synchronize()
            assert sum(kernels.launch_counts.values()) == 4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_freeze_rows_matches_where(cuda, dtype):
    """K21 against torch.where per field, bit for bit, on a batch step
    whose x_old is its x; one launch for every differing field."""
    from proxsdp_tpu_torch.parallel import batch as tbatch

    problems = [maxcut_problem(random_graph_weights(s, 10))[0]
                for s in range(6)]
    name = "float64" if dtype == torch.float64 else "float32"
    opts = tbatch._force_batch_options(tx.Options(hybrid_precision=False,
                                                  dtype=name))
    setups = [preprocess(p) for p in problems]
    o = tbatch._batch_operands(setups, dtype, cuda, "auto")
    s = tbatch._stack_states(setups[0].layout, opts, setups, cuda)
    run = tbatch.make_batch_runner(setups[0].layout, opts, device=cuda)[0]
    s = run(s, o, 3)
    new = tsolver._scalar_step(s, o, setups[0].layout, opts,
                               kernels.control_step(setups[0].layout, opts,
                                                    cuda))
    mask = torch.tensor([True, False, True, False, False, True], device=cuda)
    kernels.reset_launch_counts()
    got = tbatch._where_rows(mask, new, s)
    torch.cuda.synchronize()
    assert sum(kernels.launch_counts.values()) == 1
    for f in tsolver.STATE_FIELDS:
        n, old = getattr(new, f), getattr(s, f)
        pairs = zip(n, old, getattr(got, f)) if f == "warm" else [
            (n, old, getattr(got, f))]
        for a, b, g in pairs:
            w = torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
            _bits_equal([g], [w])
    assert got.x is not got.x_old
