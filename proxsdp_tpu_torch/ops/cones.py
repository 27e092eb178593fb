"""Cone projections (``proxsdp_tpu/ops/cones.py``), the ported branches.

* ``box_projection`` -- the dual's box {b} x (-inf, h] (cones.py:26-40,
  reference src/prox_operators.jl:160-170); on the solver's path it runs
  fused inside kernel K2, and this is its plain form;
* ``psd_projection_block`` (cones.py:124-554) with
  - the ``side == 1`` branch;
  - the dense-eigh ``full_path`` and ``full_path_sub`` (204-232):
    ``torch.linalg.eigh`` (LAPACK on the CPU, cuSOLVER on the card, NaN
    for a non-finite input as in JAX) and the reconstruction V diag(w+)
    V^T, kernel K18 (``kernels.psd_reconstruct``);
  - the Newton-Schulz polar projection ``polar_psd`` (62-109), kernels K5
    (the products) and K6 (scaling, symmetrisation, guard);
  - the persistent-subspace step ``_subspace_body`` (427-517) in its f32
    and mixed f64 forms, with ``_cholqr2`` (K7) and its fallbacks
    ``polar_reseed`` (265-314) or ``full_path_sub``.  The k x k eigh and
    the tall-skinny products are library calls; the acceptance test is
    kernel K8.  ``lax.cond(conv_ok, ...)`` becomes one host read of K8's
    flag, the same sync the eigh already costs;
  - the sign-based subspace step ``_subspace_body_sign`` (337-425,
    ``subspace_sign=True`` in an f32 program that is neither mixed nor
    accept-always, the gate of 317-321): K7 twice, the two tall-skinny
    library products, then kernel K17 (the k x k Newton-Schulz sign, the
    residual and the test in one launch), one host read of its flags and
    on accept the library reconstruction Q Bp Q^T with its NaN guard;
  - the accept-always step (``subspace_accept_always=True``, 497-510):
    kernel K12 at B = 1 on the packed block, the reconstruction applied
    without a test or a reseed and no host read.  A square block is
    packed for it by K10 and unpacked after (K12 reads packed triangles;
    two K10 launches of side^2 words cost far less than the step);
  - the Lanczos low-rank projection (542-619) above ``full_eig_max_side``:
    ``ops.lanczos.lanczos_topk`` (kernel K11, then the ncv x ncv eigh and
    K5's Ritz rotation), the residual test on the ``target_rank`` leading
    Ritz pairs (one host read, like K8's flag) and the rank-``target_rank``
    reconstruction W W^T; the fallback (a rejected test, a force_full
    pulse) and the overflow (target_rank above
    ``max_target_rank_krylov_eigs``) are the polar projection at a giant
    side and the dense eigh otherwise -- a dead branch, since the gating
    needs a giant side (ROADMAP C2), reproduced as the JAX package has it.

A packed-triangle block (``square_form=False``) goes through K10's
``tri_to_square`` before its projection and ``square_to_tri`` after it,
with no symmetrisation (cones.py:166-174); the accept-always step takes it
as it is.

* ``psd_projection_small_batch`` (cones.py:622-675): the dense-eigh
  projection of B same-side blocks, packed scaled triangles (the batch
  driver's layout: kernel K10 on both sides of the eigh) or square; on the
  card the eigendecomposition, reconstruction and rank are kernel K9, on
  the CPU ``torch.linalg.eigh``; on the card K9 to side 118 (f64) / 168
  (f32), K9L above;
* ``polar_psd_batch``: ``polar_psd`` vmapped (the batch driver's
  ``projection="polar"``, parallel/batch.py:141 over cones.py:62-109),
  on the batched entry points of K5 and K6 (K5b, K6b): one launch a
  product for the whole batch, each instance's own scale, rank and guard.

The batch driver's accept-always subspace step (cones.py:427-510 with its
``subspace_accept_always`` branch 497-510, vmapped by
parallel/batch.py:141) is kernel K12 (K12L past one block's shared
memory), ``kernels.batched_subspace``, which ``parallel/batch.py`` calls
directly.

The SOC projection (cones.py:43-56) is kernel K13,
``kernels.soc_projection``, which ``solver._primal_step`` calls on all
SOC blocks at once.

Under a tensor-parallel solve (``tp_shards > 0`` inside
``parallel.sharded.solve_sharded``; the row layout of cones.py:177-191)
a rank reconstructs only its rows of a dense-eigh projection (K18 on rows
``span(side)`` after the replicated eigh) and runs each Newton-Schulz
product of the polar projection on its row slab of K5, an all_gather
after each; the subspace, sign, accept-always and Lanczos steps run
replicated, and their host reads (accept flags, the Lanczos residual
test) are rank 0's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..parallel.dist import LOCAL
from ..parallel.sharded import current_tp
from ..utils.vech import sympackeddim
from .lanczos import lanczos_topk

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
    # a dense eigh or a polar reseed ran, or the NaN guard of the sign or
    # accept-always step fired: a host bool, or a 0-d device bool where
    # only the device knows (the guard)
    used_full: bool | torch.Tensor
    # subspace diagnostics [rnmax/scale, min_theta, npos], zeros elsewhere
    sub_stats: torch.Tensor


def _gemm(tp, A, B, C=None, alpha: float = 0.0, beta: float = 1.0):
    """K5's alpha * C + beta * (A @ B); under tensor parallelism on the
    rank's row slab of A and C, then one all_gather of the rows."""
    if not tp.sharded:
        return kernels.ns_gemm(A, B, C, alpha, beta)
    r0, r1 = tp.span(A.shape[0])
    part = kernels.ns_gemm(A[r0:r1], B, None if C is None else C[r0:r1],
                           alpha, beta)
    return tp.all_gather_rows(part, A.shape[0])


def _newton_schulz(X, ct, *, aggressive: int, polish: int, tp=LOCAL):
    """(S, Xc, P) of a polar projection computed in ``ct``: Xc = X cast,
    S the Newton-Schulz sign of Xc, P = 0.5 * Xc + 0.5 * S @ Xc
    (cones.py:82-95, 279-293); the products row-split over ``tp``."""
    Y, Xc = kernels.fro_scale(X, ct)
    for _ in range(aggressive):
        A = _gemm(tp, Y, Y)
        B = _gemm(tp, A, A, A, POLAR_QB, POLAR_QC)
        Y = _gemm(tp, Y, B, Y, POLAR_QA, 1.0)
    for _ in range(polish):
        A = _gemm(tp, Y, Y)
        Y = _gemm(tp, Y, A, Y, 1.5, -0.5)
    S = kernels.sym(Y)
    return S, Xc, _gemm(tp, S, Xc, Xc, 0.5, 0.5)


def polar_psd(X, *, aggressive: int, polish: int, opts=None):
    """PSD projection by a Newton-Schulz matrix sign (cones.py:62-109):
    (Xp, rank) with rank = round(trace((I + sign) / 2)); a non-finite
    result passes X through with rank = side.  ``opts`` of a
    tensor-parallel solve row-split the products."""
    S, Xc, P = _newton_schulz(X, X.dtype, aggressive=aggressive,
                              polish=polish,
                              tp=LOCAL if opts is None else current_tp(opts))
    Xp, rank, _ = kernels.sym_guard(P, S, Xc)
    return Xp, rank


def polar_psd_batch(X, *, aggressive: int, polish: int):
    """``polar_psd`` of each (s, s) instance of X (B, s, s), computed in X's
    type: (Xp (B, s, s), rank (B,) int32); an instance whose Xp has a
    non-finite value passes its X through with rank = s."""
    Y = kernels.fro_scale_batch(X)
    for _ in range(aggressive):
        A = kernels.ns_gemm_batch(Y, Y)
        B = kernels.ns_gemm_batch(A, A, A, POLAR_QB, POLAR_QC)
        Y = kernels.ns_gemm_batch(Y, B, Y, POLAR_QA, 1.0)
    for _ in range(polish):
        A = kernels.ns_gemm_batch(Y, Y)
        Y = kernels.ns_gemm_batch(Y, A, Y, 1.5, -0.5)
    S = kernels.sym_batch(Y)
    P = kernels.ns_gemm_batch(S, X, X, 0.5, 0.5)
    Xp, rank, _ = kernels.sym_guard_batch(P, S, X)
    return Xp, rank


def _cholqr2(Y):
    """CholeskyQR2 (cones.py:243-263): two K7 passes, the jitter keyed on
    Y's (the compute) dtype."""
    return kernels.cholqr(kernels.cholqr(Y))


def _eigh(A):
    """torch.linalg.eigh with jnp.linalg.eigh's semantics on a non-finite
    input, and where LAPACK's or cuSOLVER's iteration does not converge:
    NaN eigenpairs (torch raises in both cases; the NaNs send the caller
    to its fallback, as in the JAX package).  An all-zero input (the cold
    start's first projection) gets LAPACK's answer, w = 0 and V = I: there
    cuSOLVER leaves its outputs as the allocator handed them over, so on
    the card they held whatever freed memory held (NaN after a NaN
    guard).  The tests are on the device, so they cost no host sync."""
    ok = torch.all(torch.isfinite(A))
    nz = torch.any(A != 0)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    try:
        w, V = torch.linalg.eigh(torch.where(ok & nz, A, eye))
    except torch.linalg.LinAlgError:
        return (torch.full(A.shape[:-1], torch.nan, dtype=A.dtype,
                           device=A.device), torch.full_like(A, torch.nan))
    w, V = torch.where(nz, w, 0.0), torch.where(nz, V, eye)
    return torch.where(ok, w, torch.nan), torch.where(ok, V, torch.nan)


def _eig_dtype(dtype, opts):
    # mixed_projection: an f32 program's dense eigh runs in f64
    if opts.mixed_projection and dtype == torch.float32:
        return torch.float64
    return dtype


def _dense_eigh(X, opts):
    """(Xp, rank, V): the positive eigenpairs of X, V ascending; Xp = V
    diag(w+) V^T by K18, under tensor parallelism the rank's rows of it and
    one all_gather."""
    w, V = _eigh(X.to(_eig_dtype(X.dtype, opts)))
    side, tp = X.shape[0], current_tp(opts)
    if not tp.sharded:
        Xp = kernels.psd_reconstruct(V, w, 0, side, X.dtype)
    else:
        r0, r1 = tp.span(side)
        Xp = tp.all_gather_rows(
            kernels.psd_reconstruct(V, w, r0, r1, X.dtype), side)
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
                             polish=opts.polar_polish, tp=current_tp(opts))
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
    if current_tp(opts).flag(flags[0]):  # the one host read of the step
        Xp = torch.matmul(W * lam[None, :], W.T)
        return Xp, stats[1], flags[1], W.flip(1), False, stats
    if opts.subspace_fallback == "polar":
        Xp, me, cur, wv = polar_reseed(X, warm, bdt, opts)
    else:
        Xp, me, cur, wv = full_path_sub(X, k, opts)
    return Xp, me, cur, wv, True, stats


def _subspace_body_sign(X, warm, k: int, opts, accept_tol, force_full: bool):
    """The matmul-only subspace step (cones.py:337-425): Newton-Schulz
    sign(B) of the Rayleigh quotient B instead of its eigh, an aggregate
    residual test, (B + sign(B) B) / 2 projected back; f32 only.  Returns
    (Xp, min_eig, rank, warm, used_full, sub_stats)."""
    Q = _cholqr2(torch.matmul(X, warm))
    Z = torch.matmul(X, Q)
    Bp, stats, info = kernels.subspace_sign(
        Q, Z, accept_tol, opts.subspace_tol, opts.polar_aggressive,
        opts.polar_polish, force_full)
    if current_tp(opts).flag(info[0]):  # the one host read of the step
        Xp = torch.matmul(Q, torch.matmul(Bp, Q.T))
        bad = ~torch.all(torch.isfinite(Xp))
        return (torch.where(bad, X, Xp), X.new_zeros(()), info[1],
                torch.where(bad, warm, Q), bad, stats)
    if opts.subspace_fallback == "polar":
        Xp, me, cur, wv = polar_reseed(X, warm, X.dtype, opts)
    else:
        Xp, me, cur, wv = full_path_sub(X, k, opts)
    return Xp, me, cur, wv, True, stats


def _use_sign(dtype, opts) -> bool:
    """The sign body's gate (cones.py:317-321): an f32 program (the mixed
    mode is an f64 program's) without the accept-always step."""
    return (bool(opts.subspace_sign) and dtype == torch.float32
            and not opts.subspace_accept_always)


def _accept_always(v, warm, side: int, opts) -> PsdProjResult:
    """The accept-always subspace step (cones.py:497-510) on a packed
    scaled triangle v (tri_len,): kernel K12 at B = 1.  The eigh body's
    reconstruction runs unconditionally; where it is not finite, X and the
    old basis go out and used_full is set (on the device: no host read)."""
    mixed = bool(opts.subspace_mixed) and v.dtype == torch.float64
    blocks, me, rank, wv, bad, stats = kernels.batched_subspace(
        v.view(1, -1), warm.unsqueeze(0), side, opts.tol_psd, mixed=mixed)
    return PsdProjResult(blocks[0], me[0], rank[0], wv[0], bad[0], stats[0])


def lanczos_ncv(side: int, opts) -> int:
    """Lanczos steps of a side (cones.py:565-573): at least 2 k_max + 1 and
    ``eigsolver_min_lanczos``, side // 32 at a giant side (above
    ``full_eig_max_side``, so every side of the branch: ROADMAP C3)."""
    giant = side > opts.full_eig_max_side
    return min(max(2 * opts.max_target_rank_krylov_eigs + 1,
                   opts.eigsolver_min_lanczos,
                   side // 32 if giant else 0), side)


def projection_kind(side: int, opts, warm_is_basis: bool) -> str:
    """The branch ``psd_projection_block`` takes for a side: "scalar",
    "subspace" (the warm start is a (side, k) basis), "polar", "lanczos"
    (the gating of cones.py:542-548) or "full".  The chunk runner asks it
    too, to know when to read the target rank with the status."""
    if side == 1:
        return "scalar"
    if 0 < min(opts.subspace_rank, side) < side // 2 and warm_is_basis:
        return "subspace"
    if opts.projection == "polar" and side >= opts.polar_min_side:
        return "polar"
    if (not opts.full_eig_decomp and opts.use_lanczos
            and side > opts.min_size_krylov_eigs
            and side > opts.full_eig_max_side):
        return "lanczos"
    return "full"


def _lanczos_path(X, warm, target_rank: int, opts, force_full: bool):
    """The Lanczos branch (cones.py:560-619): (Xp, min_eig, rank, warm,
    used_full).  Host decisions: ``target_rank`` against the Krylov cap and
    the force_full pulse, then one read of the residual test."""
    side = X.shape[0]
    giant = side > opts.full_eig_max_side

    def fallback():
        if giant:  # polar, never a giant dense eigh
            Xp, rank = polar_psd(X, aggressive=opts.polar_aggressive,
                                 polish=opts.polar_polish, opts=opts)
            return Xp, X.new_zeros(()), rank, warm, True
        return (*full_path(X, opts), True)

    if target_rank > opts.max_target_rank_krylov_eigs or force_full:
        return fallback()
    ncv = lanczos_ncv(side, opts)
    tol = opts.krylovkit_tol
    out = lanczos_topk(X, warm, ncv=ncv, tol=tol)
    k = min(target_rank, ncv)  # >= 2: target ranks start at 2 and grow
    vals = out.vals[:k]
    thresh = torch.clamp_min(tol * torch.abs(vals), 10 * tol)
    # the one host read (rank 0's under tensor parallelism)
    if not current_tp(opts).flag(torch.all(out.resid[:k] <= thresh)):
        return fallback()
    pos = vals > 0.0
    W = out.vecs[:, :k] * torch.sqrt(torch.where(pos, vals, 0.0))[None, :]
    Xp = torch.matmul(W, W.T)
    return (Xp, torch.amin(vals), torch.sum(pos).to(torch.int32),
            out.vecs[:, 0], False)


def psd_projection_block(X, warm, *, opts, accept_tol=None,
                         force_full: bool = False,
                         target_rank=None) -> PsdProjResult:
    """Project one PSD block onto the PSD cone.

    ``X`` is the symmetric (side, side) matrix of a square-form block --
    on the solver's path kernel K4 fuses the symmetrisation (cones.py:
    172-173) into the primal update -- or the packed scaled triangle
    (tri_len,) of a ``square_form=False`` block; the projection comes back
    in the same form.  The branch is ``projection_kind``'s: the subspace
    step when ``0 < k < side // 2`` for k = min(subspace_rank, side) and
    the warm start is a (side, k) basis (the accept-always step, the sign
    body or the eigh body); else the polar projection when ``projection ==
    "polar"`` and side >= polar_min_side; else, at a side above
    ``full_eig_max_side`` and ``min_size_krylov_eigs``, the Lanczos
    projection of ``target_rank`` pairs (an int, or a 0-d tensor read once
    on the host; that branch needs it); else the dense eigh.
    ``accept_tol`` (a 0-d tensor) and the host flag ``force_full`` feed
    the subspace tests; ``force_full`` also sends the Lanczos branch to
    its fallback.
    """
    packed = X.dim() == 1
    side = sympackeddim(X.shape[0]) if packed else X.shape[0]
    kind = projection_kind(side, opts, warm.dim() == 2)
    if kind == "scalar":
        proj = torch.clamp_min(X.reshape(1), 0.0)
        return PsdProjResult(proj.reshape(X.shape), proj[0],
                             (proj[0] > 0).to(torch.int32), warm, False,
                             X.new_zeros(3))
    if kind == "subspace" and opts.subspace_accept_always:
        if packed:
            return _accept_always(X, warm, side, opts)
        res = _accept_always(kernels.square_to_tri(X.view(1, side, side),
                                                   side)[0], warm, side, opts)
        return res._replace(block=kernels.tri_to_square(
            res.block.view(1, -1), side)[0])
    if packed:
        res = psd_projection_block(
            kernels.tri_to_square(X.view(1, -1), side)[0], warm, opts=opts,
            accept_tol=accept_tol, force_full=force_full,
            target_rank=target_rank)
        return res._replace(block=kernels.square_to_tri(
            res.block.view(1, side, side), side)[0])
    zero3 = X.new_zeros(3)
    if kind == "subspace":
        k = int(min(opts.subspace_rank, side))
        body = _subspace_body_sign if _use_sign(X.dtype, opts) else _subspace_body
        return PsdProjResult(*body(X, warm, k, opts, accept_tol, force_full))
    if kind == "polar":
        Xp, rank = polar_psd(X, aggressive=opts.polar_aggressive,
                             polish=opts.polar_polish, opts=opts)
        return PsdProjResult(Xp, X.new_zeros(()), rank, warm, False, zero3)
    if kind == "lanczos":
        if target_rank is None:
            raise ValueError("psd_projection_block: the Lanczos branch needs "
                             "target_rank")
        return PsdProjResult(*_lanczos_path(X, warm, int(target_rank), opts,
                                            force_full), zero3)
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
