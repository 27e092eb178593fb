"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

Each wrapper takes tensors on one device.  On the CPU it runs the plain
PyTorch version beside it (the tests' path); on a CUDA device it launches
the kernel from ``csrc/`` (built at first use by ``build.py``) or raises --
nothing falls back.  Each launch adds one to ``launch_counts`` under its
entry point ("residuals_f32", "sym_guard_f32_f64"); ``kernel_launches``
sums them by kernel.  They show that a run really went through the
kernels.

| wrapper            | replaces (JAX package)                           |
|--------------------|--------------------------------------------------|
| ell_spmv           | ops/linop.py:123-127 EllOp.matvec / rmatvec      |
| ls_dual_update     | solver.py:452-463 linesearch body + box proj.    |
| sq_dist            | solver.py:459-461 the accept test's norms        |
| residuals          | solver.py:545-612 _residuals_and_gap reductions  |
| primal_update_sym  | solver.py:308 + ops/cones.py:172-173             |
| ns_gemm            | ops/cones.py:84-95, 285-297 the polar products   |
| fro_scale          | ops/cones.py:85-86, 279-284 Frobenius scaling    |
| sym                | ops/cones.py:94, 292 S = (Y + Y^T) / 2           |
| sym_guard          | ops/cones.py:96-109, 294-310 Xp, guard and rank  |
| cholqr             | ops/cones.py:243-263 one CholeskyQR pass         |
| ritz_accept        | ops/cones.py:443-489 the Ritz acceptance test    |
| batched_psd_eigh   | ops/cones.py:622-675, 204-211 batched eigh proj. |
| tri_to_square      | ops/tri.py:39-44 (batched)                       |
| square_to_tri      | ops/tri.py:47-52 (batched)                       |

The batch driver (``parallel/batch.py``) runs K1-K4 through their
``*_batch`` entry points: a leading instance axis on every vector,
per-instance step scalars as (B,) tensors and per-instance b, h, c, one
launch per batch.

The f32 and f64 instantiations share one source each; ``fro_scale`` and
``sym_guard`` also take the mixed f64/f32 pairs of the f64 program's
f32-compute polar reseed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ops.cones import box_projection
from ..utils.vech import offdiag_mask_tri, square_gather_index, tri_ij
from . import build

# the single-instance solve's kernels and the batch driver's
SOLVE_KERNELS = ("ell_spmv", "ls_dual_update", "sq_dist", "residuals",
                 "primal_update_sym", "ns_gemm", "fro_scale", "sym",
                 "sym_guard", "cholqr", "ritz_accept")
BATCH_KERNELS = ("ell_spmv_batch", "ls_dual_update_batch", "sq_dist_batch",
                 "residuals_batch", "primal_update_batch", "batched_psd_eigh",
                 "tri_to_square", "square_to_tri")
KERNELS = SOLVE_KERNELS + BATCH_KERNELS

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
_ARGTYPES = {
    "ell_spmv": [_P, _P, _P, _P, _I, _I, _P],
    "ls_dual_update": [_P] * 11 + [_I, _I, _P],
    "sq_dist": [_P, _P, _P, _P, _I, _P],
    "residuals": [_P] * 15 + [_I] * 4 + [_P],
    "primal_update_sym": [_P] * 5 + [_I, _I, _P],
    "ns_gemm": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _D, _D, _P],
    "fro_scale": [_P] * 4 + [_I, _P],
    "sym": [_P, _P, _I, _P],
    "sym_guard": [_P] * 7 + [_I, _P],
    "cholqr": [_P, _P, _I, _I, _D, _P],
    "ritz_accept": [_P] * 4 + [_I, _I, _D, _D, _I] + [_P] * 4,
    "ell_spmv_batch": [_P] * 4 + [_I] * 4 + [_P],
    "ls_dual_update_batch": [_P] * 10 + [_I] * 3 + [_P],
    "sq_dist_batch": [_P] * 3 + [_I, _I, _P],
    "residuals_batch": [_P] * 14 + [_I] * 4 + [_P],
    "primal_update_batch": [_P] * 5 + [_I, _I, _P],
    "batched_psd_eigh": [_P] * 5 + [_I, _I, _D, _P],
    "tri_to_square": [_P] * 4 + [_I] * 3 + [_P],
    "square_to_tri": [_P] * 4 + [_I] * 3 + [_P],
}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
# entry points of mixed type pairs: (input, output) dtype suffixes
_MIXED = {"fro_scale": ("f64_f32",), "sym_guard": ("f32_f64",)}


def _suffixes(name: str) -> tuple[str, ...]:
    return (*_SUFFIX.values(), *_MIXED.get(name, ()))


# launches by entry point, e.g. "residuals_f32", "sym_guard_f32_f64"
launch_counts = {f"{name}_{sfx}": 0 for name in KERNELS
                 for sfx in _suffixes(name)}


def reset_launch_counts() -> None:
    for entry in launch_counts:
        launch_counts[entry] = 0


def kernel_launches() -> dict[str, int]:
    """``launch_counts`` summed over each kernel's entry points."""
    return {name: sum(launch_counts[f"{name}_{sfx}"] for sfx in _suffixes(name))
            for name in KERNELS}


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = build.load()
    for name, argtypes in _ARGTYPES.items():
        for sfx in _suffixes(name):
            fn = getattr(lib, f"proxsdp_{name}_{sfx}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load() -> None:
    """Build (if needed) and load the kernel library now."""
    _library()


def _launch(name: str, dtype, device: torch.device, *args):
    """Launch ``proxsdp_{name}_{suffix}``; ``dtype`` is a torch dtype or an
    entry-point suffix such as "f64_f32"."""
    sfx = dtype if isinstance(dtype, str) else _SUFFIX[dtype]
    fn = getattr(_library(), f"proxsdp_{name}_{sfx}")
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
    launch_counts[f"{name}_{sfx}"] += 1


# reduce.cuh: pass-1 grid of a two-pass reduction over n elements
def _reduce_grid(n: int) -> int:
    return min(max(-(-n // 256), 1), 1024)


def _on_cpu(name: str, *tensors: torch.Tensor, mixed: bool = False,
            strided: bool = False) -> bool:
    """Validate a wrapper's tensor arguments; True for the CPU path.
    ``mixed`` allows f32 and f64 tensors in one call; ``strided`` skips the
    contiguity check (the caller checked the strides its kernel takes)."""
    dev = tensors[0].device
    dtype = None
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not strided and not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor")
        if t.is_floating_point():
            if t.dtype not in _SUFFIX:
                raise TypeError(f"{name}: dtype {t.dtype} not supported")
            if dtype is None:
                dtype = t.dtype
            elif t.dtype != dtype and not mixed:
                raise TypeError(f"{name}: mixed dtypes {t.dtype}, {dtype}")
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} not supported")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: device {dev} not supported")
    return False


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _check_vec(name: str, t: torch.Tensor, n: int, what: str) -> None:
    if t.shape != (n,):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, want ({n},)")


def _check_scalar(name: str, t: torch.Tensor, what: str) -> None:
    if t.dim() != 0:
        raise ValueError(f"{name}: {what} must be a 0-d tensor")


# ---------------------------------------------------------------- K1 ELL SpMV


def ell_spmv_plain(idx: torch.Tensor, vals: torch.Tensor, v: torch.Tensor):
    return torch.sum(vals * v[idx], dim=1)


def ell_spmv(idx: torch.Tensor, vals: torch.Tensor, v: torch.Tensor):
    """out[r] = sum_j vals[r, j] * v[idx[r, j]] (idx int32, in range)."""
    name = "ell_spmv"
    if idx.dtype != torch.int32 or idx.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"{name}: want int32 idx and vals of one 2-d shape")
    if v.dim() != 1 or idx.shape[1] < 1:
        raise ValueError(f"{name}: bad v or table width")
    if _on_cpu(name, idx, vals, v):
        return ell_spmv_plain(idx, vals, v)
    nrows, width = idx.shape
    out = torch.empty(nrows, dtype=v.dtype, device=v.device)
    _launch(name, v.dtype, v.device, _ptr(idx), _ptr(vals), _ptr(v), _ptr(out),
            nrows, width)
    return out


# ------------------------------------------- K2 linesearch dual update + norms


def ls_dual_update_plain(y, Mx, Mx_old, b, h, y_old, bp, theta, p: int, m: int):
    y_half = y + bp * ((1.0 + theta) * Mx - theta * Mx_old)
    y_temp = y_half - bp * box_projection(y_half, b, h, bp, p)
    d = y_temp - y_old
    return y_temp, torch.sum(d * d)


def ls_dual_update(y, Mx, Mx_old, b, h, y_old, bp, theta, p: int, m: int):
    """One linesearch trial's y_temp and ||y_temp - y_old||^2 (0-d)."""
    name = "ls_dual_update"
    for t, what in ((y, "y"), (Mx, "Mx"), (Mx_old, "Mx_old"), (y_old, "y_old")):
        _check_vec(name, t, p + m, what)
    _check_vec(name, b, p, "b")
    _check_vec(name, h, m, "h")
    _check_scalar(name, bp, "bp")
    _check_scalar(name, theta, "theta")
    if _on_cpu(name, y, Mx, Mx_old, b, h, y_old, bp, theta):
        return ls_dual_update_plain(y, Mx, Mx_old, b, h, y_old, bp, theta, p, m)
    y_temp = torch.empty_like(y)
    partials = torch.empty(_reduce_grid(p + m), dtype=y.dtype, device=y.device)
    sq = torch.empty((), dtype=y.dtype, device=y.device)
    _launch(name, y.dtype, y.device,
            *map(_ptr, (y, Mx, Mx_old, b, h, y_old, bp, theta, y_temp,
                        partials, sq)), p, m)
    return y_temp, sq


def sq_dist_plain(a, b):
    d = a - b
    return torch.sum(d * d)


def sq_dist(a, b):
    """sum_i (a_i - b_i)^2 as a 0-d tensor."""
    name = "sq_dist"
    _check_vec(name, b, a.shape[0], "b")
    if _on_cpu(name, a, b):
        return sq_dist_plain(a, b)
    n = a.shape[0]
    partials = torch.empty(_reduce_grid(n), dtype=a.dtype, device=a.device)
    out = torch.empty((), dtype=a.dtype, device=a.device)
    _launch(name, a.dtype, a.device, _ptr(a), _ptr(b), _ptr(partials),
            _ptr(out), n)
    return out


# ------------------------------------------------------------ K3 residuals

RESIDUAL_SLOTS = 9


@functools.lru_cache(maxsize=8)
def _offdiag_weight(n: int, side: int, dtype, device) -> torch.Tensor:
    q = torch.arange(side * side, dtype=torch.int64, device=device)
    w = torch.ones(n, dtype=dtype, device=device)
    w[: side * side][q // side != q % side] = math.sqrt(2.0)
    return w


def _max_abs(v):
    """max |v| over the last axis (0 for an empty one)."""
    return (torch.amax(torch.abs(v), dim=-1) if v.shape[-1]
            else v.new_zeros(v.shape[:-1]))


DOT_CHUNK = 128  # the JAX f32 program's dot chunk (solver.py:526-537)


def _chunk_dot(a, b):
    """f32 dot over the last axis in two stages: products summed in
    128-element chunks in the order of residuals.cu's warps (lane l adds
    elements l, l+32, l+64, l+96, then a shuffle tree folds the lanes 16,
    8, 4, 2, 1 apart), then the chunk sums added in f64."""
    prod = a * b
    lead = prod.shape[:-1]
    pad = (-prod.shape[-1]) % DOT_CHUNK
    if pad:
        prod = torch.cat([prod, prod.new_zeros(*lead, pad)], dim=-1)
    s = prod.view(*lead, -1, 4, 32)
    s = ((s[..., 0, :] + s[..., 1, :]) + s[..., 2, :]) + s[..., 3, :]
    for half in (16, 8, 4, 2, 1):
        s = s[..., :half] + s[..., half : 2 * half]
    return torch.sum(s[..., 0].double(), dim=-1)


def residuals_plain(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma,
                    b, h, c, p: int, m: int, side: int):
    w = _offdiag_weight(x.shape[0], side, x.dtype, x.device)
    px_old = x_old - tau * Mty_old
    px = x - tau * Mty
    py_old = y_old - sigma * Mx_old
    py = y - sigma * Mx
    ineq = (torch.amax(Mx[p:] - h) if m
            else torch.tensor(-math.inf, dtype=x.dtype, device=x.device))
    maxima = torch.stack([
        _max_abs((px - px_old) * w),
        _max_abs(px_old * w),
        _max_abs(py - py_old),
        _max_abs(py_old),
        _max_abs(Mx[:p] - b),
        ineq,
    ]).double()
    if x.dtype == torch.float64:
        dots = [torch.dot(c, x), torch.dot(b, y[:p]), torch.dot(h, y[p:])]
    else:
        dots = [_chunk_dot(c, x), _chunk_dot(b, y[:p]), _chunk_dot(h, y[p:])]
    return torch.cat([maxima, torch.stack(dots)])


def residuals(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma,
              b, h, c, p: int, m: int, side: int):
    """The nine reductions of residuals.cu (see its header) as a (9,) f64
    tensor; the square PSD block of ``side`` sits at offset 0 of x.  For
    f32 inputs the maxima are f32 values and the dots two-stage sums."""
    name = "residuals"
    n = x.shape[0]
    for t, what in ((x, "x"), (x_old, "x_old"), (Mty, "Mty"),
                    (Mty_old, "Mty_old"), (c, "c")):
        _check_vec(name, t, n, what)
    for t, what in ((y, "y"), (y_old, "y_old"), (Mx, "Mx"), (Mx_old, "Mx_old")):
        _check_vec(name, t, p + m, what)
    _check_vec(name, b, p, "b")
    _check_vec(name, h, m, "h")
    _check_scalar(name, tau, "tau")
    _check_scalar(name, sigma, "sigma")
    if side * side > n:
        raise ValueError(f"{name}: block of side {side} exceeds n={n}")
    args = (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c)
    if _on_cpu(name, *args):
        return residuals_plain(*args, p, m, side)
    if x.dtype == torch.float64:
        grid = _reduce_grid(max(n, p + m))
    else:  # residuals.cu:f32_grid, one warp per 128-element chunk
        chunks = sum(-(-k // DOT_CHUNK) for k in (n, p, m))
        grid = _reduce_grid(32 * chunks)
    partials = torch.empty(grid * RESIDUAL_SLOTS, dtype=torch.float64,
                           device=x.device)
    out = torch.empty(RESIDUAL_SLOTS, dtype=torch.float64, device=x.device)
    _launch(name, x.dtype, x.device, *map(_ptr, args + (partials, out)),
            n, p, m, side)
    return out


# ------------------------------------------ K4 primal update + symmetrise


def primal_update_sym_plain(x, Mty, c, tau, side: int):
    u = x - tau * (Mty + c)
    s2 = side * side
    if not side:
        return u
    X = u[:s2].view(side, side)
    return torch.cat([(0.5 * (X + X.T)).reshape(-1), u[s2:]])


def primal_update_sym(x, Mty, c, tau, side: int):
    """u = x - tau*(Mty + c) with its leading side x side block symmetrised."""
    name = "primal_update_sym"
    n = x.shape[0]
    _check_vec(name, Mty, n, "Mty")
    _check_vec(name, c, n, "c")
    _check_scalar(name, tau, "tau")
    if side * side > n:
        raise ValueError(f"{name}: block of side {side} exceeds n={n}")
    if _on_cpu(name, x, Mty, c, tau):
        return primal_update_sym_plain(x, Mty, c, tau, side)
    out = torch.empty_like(x)
    _launch(name, x.dtype, x.device, _ptr(x), _ptr(Mty), _ptr(c), _ptr(tau),
            _ptr(out), n, side)
    return out


# ---------------------------------------------- K5 GEMM with axpby epilogue


def _check_matrix(name: str, t: torch.Tensor, what: str) -> None:
    """2-d with unit column stride (a column slice of a row-major matrix
    is fine: the kernel takes the row stride)."""
    if t.dim() != 2 or (t.shape[1] > 1 and t.stride(1) != 1):
        raise ValueError(f"{name}: {what} must be 2-d with contiguous rows")


def _row_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def ns_gemm_plain(A, B, C=None, alpha: float = 0.0, beta: float = 1.0):
    prod = beta * torch.matmul(A, B)
    return prod if C is None else alpha * C + prod


def ns_gemm(A, B, C=None, alpha: float = 0.0, beta: float = 1.0):
    """out = alpha * C + beta * (A @ B) (C may be None: beta * (A @ B)), a
    new contiguous (M, N) tensor; each product alpha * C, beta * (A @ B)
    is rounded, then the two are added."""
    name = "ns_gemm"
    mats = (A, B) if C is None else (A, B, C)
    for t, what in zip(mats, ("A", "B", "C")):
        _check_matrix(name, t, what)
    M, K = A.shape
    if B.shape[0] != K or (C is not None and C.shape != (M, B.shape[1])):
        raise ValueError(f"{name}: shapes {tuple(A.shape)} @ {tuple(B.shape)}"
                         f" + {None if C is None else tuple(C.shape)}")
    if _on_cpu(name, *mats, strided=True):
        return ns_gemm_plain(A, B, C, alpha, beta)
    N = B.shape[1]
    out = torch.empty((M, N), dtype=A.dtype, device=A.device)
    if out.numel() == 0:  # nothing to compute (a zero-sized grid)
        return out
    _launch(name, A.dtype, A.device, _ptr(A), _row_stride(A), _ptr(B),
            _row_stride(B), None if C is None else _ptr(C),
            0 if C is None else _row_stride(C), _ptr(out), M, N, K,
            float(alpha), float(beta))
    return out


# ------------------------------------ K6 Frobenius scaling, sym and guard


def fro_scale_plain(X, dtype):
    Xc = X.to(dtype)
    s = torch.sqrt(torch.sum(Xc * Xc)) + 1e-30
    return Xc / s, Xc


def fro_scale(X, dtype=None):
    """(Y, Xc): Xc = X cast to the compute type ``dtype`` (default X's) and
    Y = Xc / (||Xc||_F + 1e-30) (polar_psd's scaling)."""
    name = "fro_scale"
    dtype = dtype or X.dtype
    if _on_cpu(name, X):
        return fro_scale_plain(X, dtype)
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: compute dtype {dtype} not supported")
    if X.dtype != dtype and (X.dtype, dtype) != (torch.float64, torch.float32):
        raise TypeError(f"{name}: {X.dtype} -> {dtype} not supported")
    n = X.numel()
    Y = torch.empty(X.shape, dtype=dtype, device=X.device)
    Xc = X if X.dtype == dtype else torch.empty_like(Y)
    partials = torch.empty(_reduce_grid(n), dtype=dtype, device=X.device)
    sfx = _SUFFIX[dtype] if X.dtype == dtype else "f64_f32"
    _launch(name, sfx, X.device, _ptr(X), _ptr(partials), _ptr(Y),
            None if Xc is X else _ptr(Xc), n)
    return Y, Xc


def sym_plain(Y):
    return 0.5 * (Y + Y.T)


def _check_square(name: str, t: torch.Tensor, side: int, what: str) -> None:
    if t.shape != (side, side):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"want ({side}, {side})")


def sym(Y):
    """S = 0.5 * (Y + Y^T) for a square Y."""
    name = "sym"
    side = Y.shape[0]
    _check_square(name, Y, side, "Y")
    if _on_cpu(name, Y):
        return sym_plain(Y)
    S = torch.empty_like(Y)
    _launch(name, Y.dtype, Y.device, _ptr(Y), _ptr(S), side)
    return S


def sym_guard_plain(P, S, X):
    side = X.shape[0]
    Xp = (0.5 * (P + P.T)).to(X.dtype)
    bad = ~torch.all(torch.isfinite(Xp))
    rank = torch.clamp(torch.round(0.5 * (side + torch.trace(S))), 0, side)
    return (torch.where(bad, X, Xp),
            torch.where(bad, side, rank).to(torch.int32), bad)


def sym_guard(P, S, X):
    """(Xp, rank, bad) of a polar projection: Xp = 0.5 * (P + P^T) in X's
    dtype; bad (0-d bool) when a value of Xp is not finite, and then Xp = X
    and rank = side; else rank = clip(round((side + tr S) / 2), 0, side)."""
    name = "sym_guard"
    side = X.shape[0]
    for t, what in ((P, "P"), (S, "S"), (X, "X")):
        _check_square(name, t, side, what)
    if S.dtype != P.dtype:
        raise TypeError(f"{name}: P and S must share the compute dtype")
    if _on_cpu(name, P, S, X, mixed=True):
        return sym_guard_plain(P, S, X)
    pair = (P.dtype, X.dtype)
    if P.dtype == X.dtype:
        sfx = _SUFFIX[P.dtype]
    elif pair == (torch.float32, torch.float64):
        sfx = "f32_f64"
    else:
        raise TypeError(f"{name}: P {P.dtype} with X {X.dtype} not supported")
    nt = -(-side // 32)
    flags = torch.empty(nt * nt, dtype=torch.int32, device=X.device)
    Xp = torch.empty_like(X)
    rank = torch.empty((), dtype=torch.int32, device=X.device)
    bad = torch.empty((), dtype=torch.bool, device=X.device)
    _launch(name, sfx, X.device, _ptr(P), _ptr(S), _ptr(X), _ptr(Xp),
            _ptr(flags), _ptr(rank), _ptr(bad), side)
    return Xp, rank, bad


# -------------------------------------------------------- K7 CholeskyQR

# the jitter of _cholqr2, keyed on the compute dtype (cones.py:249-256)
CHOLQR_EPS = {torch.float32: 1e-6, torch.float64: 1e-12}
# shared memory for G (k * k words) in cholqr.cu's single block
CHOLQR_SMEM_BYTES = 200 * 1024


def cholqr_plain(Y, eps: float):
    k = Y.shape[1]
    G = Y.T @ Y
    jit = eps * (torch.trace(G) / k + 1.0)
    L, info = torch.linalg.cholesky_ex(
        G + jit * torch.eye(k, dtype=Y.dtype, device=Y.device))
    # torch.linalg.cholesky raises on a non-positive pivot; the JAX
    # factor is NaN there, which the callers' finite guards rely on
    L = torch.where(info != 0, torch.nan, L)
    return torch.linalg.solve_triangular(L, Y.T, upper=False).T.contiguous()


def cholqr(Y, eps: float | None = None):
    """One CholeskyQR pass: Q = Y L^{-T} with L = chol(Y^T Y + eps *
    (tr(Y^T Y) / k + 1) I); NaN everywhere if a pivot is not positive."""
    name = "cholqr"
    if Y.dim() != 2:
        raise ValueError(f"{name}: Y must be 2-d")
    eps = CHOLQR_EPS[Y.dtype] if eps is None else eps
    if _on_cpu(name, Y):
        return cholqr_plain(Y, eps)
    side, k = Y.shape
    if k * k * Y.element_size() > CHOLQR_SMEM_BYTES:
        raise ValueError(f"{name}: k = {k} does not fit one block's shared "
                         f"memory ({CHOLQR_SMEM_BYTES} bytes for G)")
    Q = torch.empty_like(Y)
    _launch(name, Y.dtype, Y.device, _ptr(Y), _ptr(Q), side, k, float(eps))
    return Q


# ------------------------------------------- K8 Ritz acceptance test

RITZ_MAX_K = 256


def ritz_accept_plain(W, XW, theta, accept_tol, tol: float, tol_psd: float,
                      force_full: bool):
    if theta is None:
        theta = torch.sum(W * XW, dim=0) / torch.sum(W * W, dim=0)
    rn = torch.sqrt(torch.sum((XW - W * theta[None, :]) ** 2, dim=0))
    pos = theta > 0.0
    scale = torch.clamp_min(torch.amax(torch.abs(theta)), 1.0)
    thresh = torch.tensor(tol, dtype=W.dtype, device=W.device)
    if accept_tol is not None:
        thresh = torch.maximum(thresh, accept_tol)
    ok = torch.all(torch.where(pos, rn <= thresh * scale, True))
    tmin = torch.amin(theta)
    stats = torch.stack([torch.amax(torch.where(pos, rn, 0.0)) / scale, tmin,
                         torch.sum(pos).to(W.dtype)])
    conv = ok & (tmin <= tol_psd) & (not force_full)
    flags = torch.stack([conv.to(torch.int32),
                         torch.sum(theta > tol_psd).to(torch.int32)])
    return torch.clamp_min(theta, 0.0), stats, flags


def ritz_accept(W, XW, theta, accept_tol, tol: float, tol_psd: float,
                force_full: bool):
    """(lam, stats, flags) of a subspace step's acceptance test (see
    ritz_accept.cu): lam = max(theta, 0), stats = PsdProjResult.sub_stats,
    flags = int32 [conv_ok, current rank].  theta None: the Rayleigh
    quotients of W's columns; accept_tol a 0-d tensor or None."""
    name = "ritz_accept"
    if W.dim() != 2 or XW.shape != W.shape:
        raise ValueError(f"{name}: W and XW must be one (side, k) shape")
    side, k = W.shape
    extra = [t for t in (theta, accept_tol) if t is not None]
    if theta is not None:
        _check_vec(name, theta, k, "theta")
    if accept_tol is not None:
        _check_scalar(name, accept_tol, "accept_tol")
    if _on_cpu(name, W, XW, *extra):
        return ritz_accept_plain(W, XW, theta, accept_tol, tol, tol_psd,
                                 force_full)
    if k > RITZ_MAX_K:
        raise ValueError(f"{name}: k = {k} > {RITZ_MAX_K}")
    lam = torch.empty(k, dtype=W.dtype, device=W.device)
    stats = torch.empty(3, dtype=W.dtype, device=W.device)
    flags = torch.empty(2, dtype=torch.int32, device=W.device)
    _launch(name, W.dtype, W.device, _ptr(W), _ptr(XW),
            None if theta is None else _ptr(theta),
            None if accept_tol is None else _ptr(accept_tol), side, k,
            float(tol), float(tol_psd), int(bool(force_full)), _ptr(lam),
            _ptr(stats), _ptr(flags))
    return lam, stats, flags


# ------------------------------------------------ batched K1-K4 entry points
#
# The batch driver's forms of K1-K4 (parallel/batch.py): every vector has a
# leading instance axis B, the step scalars are (B,) tensors, b, h and c are
# per instance; the operator's tables are shared.  One launch per batch.


def _check_rows(name: str, t: torch.Tensor, B: int, n: int, what: str) -> None:
    if t.shape != (B, n):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"want ({B}, {n})")


def ell_spmv_batch_plain(idx, vals, V):
    return torch.sum(vals * V[:, idx], dim=-1)


def ell_spmv_batch(idx: torch.Tensor, vals: torch.Tensor, V: torch.Tensor):
    """out[b, r] = sum_j vals[r, j] * V[b, idx[r, j]] for a (B, ncols) V."""
    name = "ell_spmv_batch"
    if idx.dtype != torch.int32 or idx.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"{name}: want int32 idx and vals of one 2-d shape")
    if V.dim() != 2 or idx.shape[1] < 1:
        raise ValueError(f"{name}: bad V or table width")
    if _on_cpu(name, idx, vals, V):
        return ell_spmv_batch_plain(idx, vals, V)
    (nrows, width), (B, ncols) = idx.shape, V.shape
    out = torch.empty((B, nrows), dtype=V.dtype, device=V.device)
    _launch(name, V.dtype, V.device, _ptr(idx), _ptr(vals), _ptr(V), _ptr(out),
            B, nrows, width, ncols)
    return out


def ls_dual_update_batch_plain(y, Mx, Mx_old, b, h, y_old, bp, theta,
                               p: int, m: int):
    bp, theta = bp[:, None], theta[:, None]
    y_half = y + bp * ((1.0 + theta) * Mx - theta * Mx_old)
    y_temp = y_half - bp * box_projection(y_half, b, h, bp, p)
    d = y_temp - y_old
    return y_temp, torch.sum(d * d, dim=-1)


def ls_dual_update_batch(y, Mx, Mx_old, b, h, y_old, bp, theta, p: int,
                         m: int):
    """One linesearch trial of B instances: y_temp (B, p + m) and the
    squared distances ||y_temp - y_old||^2 (B,); bp, theta (B,)."""
    name = "ls_dual_update_batch"
    B = y.shape[0]
    for t, what in ((y, "y"), (Mx, "Mx"), (Mx_old, "Mx_old"), (y_old, "y_old")):
        _check_rows(name, t, B, p + m, what)
    _check_rows(name, b, B, p, "b")
    _check_rows(name, h, B, m, "h")
    _check_vec(name, bp, B, "bp")
    _check_vec(name, theta, B, "theta")
    if _on_cpu(name, y, Mx, Mx_old, b, h, y_old, bp, theta):
        return ls_dual_update_batch_plain(y, Mx, Mx_old, b, h, y_old, bp,
                                          theta, p, m)
    y_temp = torch.empty_like(y)
    sq = torch.empty(B, dtype=y.dtype, device=y.device)
    _launch(name, y.dtype, y.device,
            *map(_ptr, (y, Mx, Mx_old, b, h, y_old, bp, theta, y_temp, sq)),
            B, p, m)
    return y_temp, sq


def sq_dist_batch_plain(a, b):
    d = a - b
    return torch.sum(d * d, dim=-1)


def sq_dist_batch(a, b):
    """sum_i (a[k, i] - b[k, i])^2 for each row k, as a (B,) tensor."""
    name = "sq_dist_batch"
    if a.dim() != 2:
        raise ValueError(f"{name}: a must be 2-d")
    _check_rows(name, b, *a.shape, "b")
    if _on_cpu(name, a, b):
        return sq_dist_batch_plain(a, b)
    B, n = a.shape
    out = torch.empty(B, dtype=a.dtype, device=a.device)
    _launch(name, a.dtype, a.device, _ptr(a), _ptr(b), _ptr(out), B, n)
    return out


def residuals_batch_plain(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old,
                          sigma, b, h, c, p: int, m: int):
    tau, sigma = tau[:, None], sigma[:, None]
    px_old = x_old - tau * Mty_old
    px = x - tau * Mty
    py_old = y_old - sigma * Mx_old
    py = y - sigma * Mx
    ineq = (torch.amax(Mx[:, p:] - h, dim=-1) if m
            else torch.full(x.shape[:1], -math.inf, dtype=x.dtype,
                            device=x.device))
    maxima = torch.stack([
        _max_abs(px - px_old),
        _max_abs(px_old),
        _max_abs(py - py_old),
        _max_abs(py_old),
        _max_abs(Mx[:, :p] - b),
        ineq,
    ], dim=-1).double()
    if x.dtype == torch.float64:
        dots = [torch.sum(c * x, dim=-1), torch.sum(b * y[:, :p], dim=-1),
                torch.sum(h * y[:, p:], dim=-1)]
    else:
        dots = [_chunk_dot(c, x), _chunk_dot(b, y[:, :p]),
                _chunk_dot(h, y[:, p:])]
    return torch.cat([maxima, torch.stack(dots, dim=-1)], dim=-1)


def residuals_batch(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma,
                    b, h, c, p: int, m: int):
    """The nine reductions of ``residuals`` for B instances of the packed
    layout (no off-diagonal weight), as a (B, 9) f64 tensor; tau and sigma
    are (B,)."""
    name = "residuals_batch"
    B, n = x.shape
    for t, what in ((x, "x"), (x_old, "x_old"), (Mty, "Mty"),
                    (Mty_old, "Mty_old"), (c, "c")):
        _check_rows(name, t, B, n, what)
    for t, what in ((y, "y"), (y_old, "y_old"), (Mx, "Mx"), (Mx_old, "Mx_old")):
        _check_rows(name, t, B, p + m, what)
    _check_rows(name, b, B, p, "b")
    _check_rows(name, h, B, m, "h")
    _check_vec(name, tau, B, "tau")
    _check_vec(name, sigma, B, "sigma")
    args = (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c)
    if _on_cpu(name, *args):
        return residuals_batch_plain(*args, p, m)
    out = torch.empty((B, RESIDUAL_SLOTS), dtype=torch.float64, device=x.device)
    _launch(name, x.dtype, x.device, *map(_ptr, args + (out,)), B, n, p, m)
    return out


def primal_update_batch_plain(x, Mty, c, tau):
    return x - tau[:, None] * (Mty + c)


def primal_update_batch(x, Mty, c, tau):
    """u = x - tau[:, None] * (Mty + c) for (B, n) rows (no symmetrisation:
    the packed-triangle layout's update)."""
    name = "primal_update_batch"
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be 2-d")
    B, n = x.shape
    _check_rows(name, Mty, B, n, "Mty")
    _check_rows(name, c, B, n, "c")
    _check_vec(name, tau, B, "tau")
    if _on_cpu(name, x, Mty, c, tau):
        return primal_update_batch_plain(x, Mty, c, tau)
    out = torch.empty_like(x)
    _launch(name, x.dtype, x.device, _ptr(x), _ptr(Mty), _ptr(c), _ptr(tau),
            _ptr(out), B, n)
    return out


# ------------------------------------- K9 batched Jacobi PSD projection

EIGH_MAX_SIDE = 64  # batched_eigh.cu: A and V of one instance in shared memory


def _eigh_rows(X):
    """torch.linalg.eigh of a (B, s, s) batch with jnp.linalg.eigh's NaN
    for an instance with a non-finite entry, that instance alone (torch
    raises there).  The test is on the device: no host sync."""
    ok = torch.all(torch.isfinite(X), dim=(-2, -1))
    w, V = torch.linalg.eigh(torch.where(ok[:, None, None], X,
                                         torch.zeros_like(X)))
    return (torch.where(ok[:, None], w, torch.nan),
            torch.where(ok[:, None, None], V, torch.nan))


def batched_psd_eigh_plain(X, tol_psd: float):
    w, V = _eigh_rows(X)
    Xp = torch.matmul(V * torch.clamp_min(w, 0.0)[:, None, :],
                      V.transpose(-2, -1))
    rank = torch.sum(w > tol_psd, dim=-1).to(torch.int32)
    return Xp, w, rank, V[:, :, -1].contiguous()


def batched_psd_eigh(X, tol_psd: float):
    """(Xp, w, rank, warm) of B symmetric (s, s) matrices X = V diag(w) V^T,
    w ascending: Xp = V diag(max(w, 0)) V^T, rank = #{w > tol_psd} (int32),
    warm = V[:, :, -1]; NaN (rank 0) for an instance with a non-finite
    entry.  On the card s <= 64 (one CTA's shared memory)."""
    name = "batched_psd_eigh"
    if X.dim() != 3 or X.shape[1] != X.shape[2]:
        raise ValueError(f"{name}: X must be (B, s, s)")
    if _on_cpu(name, X):
        return batched_psd_eigh_plain(X, tol_psd)
    B, s, _ = X.shape
    if s > EIGH_MAX_SIDE:
        raise NotImplementedError(
            f"{name}: side {s} > {EIGH_MAX_SIDE} (the batched projection of "
            "larger blocks is not ported yet: ROADMAP A11 / B11)")
    Xp = torch.empty_like(X)
    w = torch.empty((B, s), dtype=X.dtype, device=X.device)
    rank = torch.empty(B, dtype=torch.int32, device=X.device)
    warm = torch.empty((B, s), dtype=X.dtype, device=X.device)
    _launch(name, X.dtype, X.device, _ptr(X), _ptr(Xp), _ptr(w), _ptr(rank),
            _ptr(warm), B, s, float(tol_psd))
    return Xp, w, rank, warm


# --------------------------------------------- K10 packed-triangle gathers


@functools.lru_cache(maxsize=None)
def _maps(side: int):
    """(gidx, in_scale, sq_of_tri, out_scale) on the host: the triangle
    position of each row-major square entry and its scale (1/sqrt(2) off
    the diagonal), and the square position (i, j), i <= j, of each
    triangle entry and its scale (sqrt(2) off the diagonal)."""
    gidx = square_gather_index(side)
    I, J = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    in_scale = np.where((I != J).reshape(-1), 1.0 / np.sqrt(2.0), 1.0)
    i, j = tri_ij(side)
    sq_of_tri = i * side + j
    out_scale = np.where(offdiag_mask_tri(side), np.sqrt(2.0), 1.0)
    return gidx, in_scale, sq_of_tri, out_scale


@functools.lru_cache(maxsize=32)
def _tri_maps(side: int, dtype, device):
    """``_maps`` on ``device``: (gidx, in_scale, sq_of_tri, out_scale), the
    indices int32, the scales in ``dtype``."""
    gidx, in_scale, sq_of_tri, out_scale = _maps(side)

    def idx(a):
        return torch.tensor(a, dtype=torch.int32, device=device)

    def val(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return idx(gidx), val(in_scale), idx(sq_of_tri), val(out_scale)


def tri_to_square_plain(V, side: int):
    gidx, in_scale, _, _ = _tri_maps(side, V.dtype, V.device)
    tl = side * (side + 1) // 2
    return (V[:, :tl][:, gidx.long()] * in_scale).view(-1, side, side)


def tri_to_square(V, side: int):
    """(B, side, side) dense symmetric matrices from the packed scaled
    triangles at the start of each row of V (B, >= side(side+1)/2)."""
    name = "tri_to_square"
    tl = side * (side + 1) // 2
    if V.dim() != 2 or V.shape[1] < tl:
        raise ValueError(f"{name}: V must be (B, >= {tl})")
    if _on_cpu(name, V):
        return tri_to_square_plain(V, side)
    gidx, in_scale, _, _ = _tri_maps(side, V.dtype, V.device)
    B = V.shape[0]
    out = torch.empty((B, side, side), dtype=V.dtype, device=V.device)
    _launch(name, V.dtype, V.device, _ptr(V), _ptr(gidx), _ptr(in_scale),
            _ptr(out), B, side * side, V.shape[1])
    return out


def square_to_tri_plain(X, side: int):
    _, _, sq_of_tri, out_scale = _tri_maps(side, X.dtype, X.device)
    return X.reshape(X.shape[0], -1)[:, sq_of_tri.long()] * out_scale


def square_to_tri(X, side: int):
    """(B, side(side+1)/2) packed scaled triangles of (B, side, side) X,
    read from the upper triangle."""
    name = "square_to_tri"
    if X.dim() != 3 or X.shape[1:] != (side, side):
        raise ValueError(f"{name}: X must be (B, {side}, {side})")
    if _on_cpu(name, X):
        return square_to_tri_plain(X, side)
    _, _, sq_of_tri, out_scale = _tri_maps(side, X.dtype, X.device)
    B, tl = X.shape[0], side * (side + 1) // 2
    out = torch.empty((B, tl), dtype=X.dtype, device=X.device)
    _launch(name, X.dtype, X.device, _ptr(X), _ptr(sq_of_tri), _ptr(out_scale),
            _ptr(out), B, tl, side * side)
    return out
