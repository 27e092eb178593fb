"""Cone projections (``proxsdp_tpu/ops/cones.py``), the ported branches.

* ``box_projection`` -- the dual's box {b} x (-inf, h] (cones.py:26-40,
  reference src/prox_operators.jl:160-170); on the solver's path it runs
  fused inside kernel K2, and this is its plain form;
* ``psd_projection_block`` (cones.py:124-554) with
  - the ``side == 1`` branch;
  - the dense-eigh ``full_path`` and ``full_path_sub`` (204-232):
    ``torch.linalg.eigh`` (LAPACK on the CPU, cuSOLVER on the card, NaN
    for a non-finite input as in JAX) and a plain ``torch.matmul``
    reconstruction;
  - the Newton-Schulz polar projection ``polar_psd`` (62-109), kernels K5
    (the products) and K6 (scaling, symmetrisation, guard);
  - the persistent-subspace step ``_subspace_body`` (427-517) in its f32
    and mixed f64 forms, with ``_cholqr2`` (K7) and its fallbacks
    ``polar_reseed`` (265-314) or ``full_path_sub``.  The k x k eigh and
    the tall-skinny products are library calls; the acceptance test is
    kernel K8.  ``lax.cond(conv_ok, ...)`` becomes one host read of K8's
    flag, the same sync the eigh already costs.

* ``psd_projection_small_batch`` (cones.py:622-675): the dense-eigh
  projection of B same-side blocks, packed scaled triangles (the batch
  driver's layout: kernel K10 on both sides of the eigh) or square; on the
  card the eigendecomposition, reconstruction and rank are kernel K9, on
  the CPU ``torch.linalg.eigh``.

The Lanczos engine is ROADMAP A8/B10, the sign-based subspace body
(``subspace_sign=True``, cones.py:337-425) and the accept-always batch
mode are B5/B13, the SOC projection is B3'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels

POLAR_QA, POLAR_QB, POLAR_QC = 3.4445, -4.7750, 2.0315


def box_projection(v, b, h, step, p: int):
    """Equality rows pinned to b; inequality rows min(v/step, h) (on the
    last axis: a leading instance axis is carried through)."""
    return torch.cat([b, torch.minimum(v[..., p:] / step, h)], dim=-1)


class PsdProjResult(NamedTuple):
    block: torch.Tensor  # projected (side, side) matrix
    min_eig: torch.Tensor  # 0-d; full and polar paths report 0
    current_rank: torch.Tensor  # 0-d int32
    warm: torch.Tensor  # (side,) warm vector or (side, k) basis
    used_full: bool  # a dense eigh or a polar reseed ran (host bool)
    # subspace diagnostics [rnmax/scale, min_theta, npos], zeros elsewhere
    sub_stats: torch.Tensor


def _newton_schulz(X, ct, *, aggressive: int, polish: int):
    """(S, Xc, P) of a polar projection computed in ``ct``: Xc = X cast,
    S the Newton-Schulz sign of Xc, P = 0.5 * Xc + 0.5 * S @ Xc
    (cones.py:82-95, 279-293)."""
    Y, Xc = kernels.fro_scale(X, ct)
    for _ in range(aggressive):
        A = kernels.ns_gemm(Y, Y)
        B = kernels.ns_gemm(A, A, A, POLAR_QB, POLAR_QC)
        Y = kernels.ns_gemm(Y, B, Y, POLAR_QA, 1.0)
    for _ in range(polish):
        A = kernels.ns_gemm(Y, Y)
        Y = kernels.ns_gemm(Y, A, Y, 1.5, -0.5)
    S = kernels.sym(Y)
    return S, Xc, kernels.ns_gemm(S, Xc, Xc, 0.5, 0.5)


def polar_psd(X, *, aggressive: int, polish: int):
    """PSD projection by a Newton-Schulz matrix sign (cones.py:62-109):
    (Xp, rank) with rank = round(trace((I + sign) / 2)); a non-finite
    result passes X through with rank = side."""
    S, Xc, P = _newton_schulz(X, X.dtype, aggressive=aggressive,
                              polish=polish)
    Xp, rank, _ = kernels.sym_guard(P, S, Xc)
    return Xp, rank


def _cholqr2(Y):
    """CholeskyQR2 (cones.py:243-263): two K7 passes, the jitter keyed on
    Y's (the compute) dtype."""
    return kernels.cholqr(kernels.cholqr(Y))


def _eigh(A):
    """torch.linalg.eigh with jnp.linalg.eigh's semantics on a non-finite
    input: NaN eigenpairs (torch raises there).  The test is on the
    device, so it costs no host sync."""
    ok = torch.all(torch.isfinite(A))
    w, V = torch.linalg.eigh(torch.where(ok, A, torch.zeros_like(A)))
    return torch.where(ok, w, torch.nan), torch.where(ok, V, torch.nan)


def _eig_dtype(dtype, opts):
    # mixed_projection: an f32 program's dense eigh runs in f64
    if opts.mixed_projection and dtype == torch.float32:
        return torch.float64
    return dtype


def _dense_eigh(X, opts):
    """(Xp, rank, V): the positive eigenpairs of X, V ascending."""
    w, V = _eigh(X.to(_eig_dtype(X.dtype, opts)))
    Xp = torch.matmul(V * torch.clamp_min(w, 0.0)[None, :], V.T).to(X.dtype)
    return Xp, torch.sum(w > opts.tol_psd).to(torch.int32), V


def full_path(X, opts):
    Xp, cur, V = _dense_eigh(X, opts)
    return Xp, X.new_zeros(()), cur, V[:, -1].to(X.dtype)


def full_path_sub(X, k: int, opts):
    """full_path with the top-k eigenvectors (descending) as the new basis."""
    Xp, cur, V = _dense_eigh(X, opts)
    return Xp, X.new_zeros(()), cur, V[:, -k:].flip(1).to(X.dtype)


def polar_reseed(X, warm, bdt, opts):
    """Matmul-only fallback of a rejected subspace step (cones.py:265-314):
    the full polar projection of X computed in ``bdt``, and a new basis
    from the sign projector applied to the old one -- P+ on the leading
    k - 1 columns, P- on the last -- orthonormalised by _cholqr2."""
    S, _, P = _newton_schulz(X, bdt, aggressive=opts.polar_aggressive,
                             polish=opts.polar_polish)
    Xp, rank, bad = kernels.sym_guard(P, S, X)
    wb = warm.to(bdt)
    Zp = kernels.ns_gemm(S, wb[:, :-1], wb[:, :-1], 0.5, 0.5)  # P+ @ warm
    zn = kernels.ns_gemm(S, wb[:, -1:], wb[:, -1:], 0.5, -0.5)  # P- @ last
    Qn = _cholqr2(torch.cat([Zp, zn], dim=1))
    return Xp, X.new_zeros(()), rank, torch.where(bad, warm, Qn.to(X.dtype))


def _subspace_body(X, warm, k: int, opts, accept_tol, force_full: bool):
    """One Rayleigh-Ritz step on the warm (side, k) basis (cones.py:427-517):
    returns (Xp, min_eig, rank, warm, used_full, sub_stats)."""
    dtype = X.dtype
    mixed = bool(opts.subspace_mixed) and dtype == torch.float64
    bdt = torch.float32 if mixed else dtype
    Xb = X.to(bdt)
    Q = _cholqr2(torch.matmul(Xb, warm.to(bdt)))
    Zb = torch.matmul(Xb, Q)
    B = torch.matmul(Q.T, Zb)
    B = 0.5 * (B + B.T)
    if mixed:
        # f32 basis rotation; f64 Ritz values and residuals (K8)
        _, U = _eigh(B)
        W = torch.matmul(Q, U).to(dtype)
        XW = torch.matmul(X, W)
        theta = None
        tol = max(opts.subspace_tol, opts.subspace_mixed_tol)
    else:
        theta, U = _eigh(B)  # ascending
        W = torch.matmul(Q, U)
        XW = torch.matmul(Zb, U)
        tol = opts.subspace_tol
    lam, stats, flags = kernels.ritz_accept(W, XW, theta, accept_tol, tol,
                                            opts.tol_psd, force_full)
    if bool(flags[0]):  # the one host read of the step
        Xp = torch.matmul(W * lam[None, :], W.T)
        return Xp, stats[1], flags[1], W.flip(1), False, stats
    if opts.subspace_fallback == "polar":
        Xp, me, cur, wv = polar_reseed(X, warm, bdt, opts)
    else:
        Xp, me, cur, wv = full_path_sub(X, k, opts)
    return Xp, me, cur, wv, True, stats


def psd_projection_block(X, warm, *, opts, accept_tol=None,
                         force_full: bool = False) -> PsdProjResult:
    """Project the symmetric (side, side) matrix X onto the PSD cone.

    X must already be symmetric: on the solver's path kernel K4 fuses the
    symmetrisation (cones.py:172-173) into the primal update.  The branch
    follows the JAX gating: the subspace step when ``0 < k < side // 2``
    for k = min(subspace_rank, side) and the warm start is a (side, k)
    basis; else the polar projection when ``projection == "polar"`` and
    side >= polar_min_side; else the dense eigh.  ``accept_tol`` (a 0-d
    tensor) and the host flag ``force_full`` feed the subspace test.
    """
    side = X.shape[0]
    zero3 = X.new_zeros(3)
    if side == 1:
        proj = torch.clamp_min(X.reshape(1), 0.0)
        return PsdProjResult(proj.reshape(1, 1), proj[0],
                             (proj[0] > 0).to(torch.int32), warm, False, zero3)
    k = int(min(opts.subspace_rank, side))
    if 0 < k < side // 2 and warm.dim() == 2:
        return PsdProjResult(*_subspace_body(X, warm, k, opts, accept_tol,
                                             force_full))
    if opts.projection == "polar" and side >= opts.polar_min_side:
        Xp, rank = polar_psd(X, aggressive=opts.polar_aggressive,
                             polish=opts.polar_polish)
        return PsdProjResult(Xp, X.new_zeros(()), rank, warm, False, zero3)
    Xp, me, cur, wv = full_path(X, opts)
    return PsdProjResult(Xp, me, cur, wv, True, zero3)


def psd_projection_small_batch(v_blocks, side: int, *, opts):
    """Dense-eigh projection of B same-side PSD blocks (cones.py:622-675).

    ``v_blocks`` is (B, tri_len) packed scaled triangles (K10 expands them
    and packs the result) or (B, side * side) square blocks (symmetrised
    first).  Returns (blocks like ``v_blocks``, min_eig (B,) -- 0 per the
    full path's semantics, the projected value for side 1 --, rank (B,)
    int32, warm (B, side) -- the top eigenvector, ones for side 1)."""
    B = v_blocks.shape[0]
    if side == 1:
        proj = torch.clamp_min(v_blocks, 0.0)
        val = proj[:, 0]
        return proj, val, (val > 0).to(torch.int32), torch.ones_like(proj)
    dtype = v_blocks.dtype
    square_in = v_blocks.shape[1] == side * side
    if square_in:
        X = v_blocks.view(B, side, side)
        X = 0.5 * (X + X.transpose(1, 2))
    else:
        X = kernels.tri_to_square(v_blocks, side)
    Xp, _, rank, warm = kernels.batched_psd_eigh(
        X.to(_eig_dtype(dtype, opts)).contiguous(), opts.tol_psd)
    Xp, warm = Xp.to(dtype), warm.to(dtype)
    blocks = (Xp.reshape(B, side * side) if square_in
              else kernels.square_to_tri(Xp, side))
    return blocks, v_blocks.new_zeros(B), rank, warm
