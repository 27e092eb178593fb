"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

Each wrapper takes tensors on one device.  On the CPU it runs the plain
PyTorch version beside it (the tests' path); on a CUDA device it launches
the kernel from ``csrc/`` (built at first use by ``build.py``) or raises
``KernelError`` -- nothing falls back.  Each launch adds one to ``launch_counts`` under its
entry point ("residuals_f32", "sym_guard_f32_f64"); ``kernel_launches``
sums them by kernel.  They show that a run really went through the
kernels.

| wrapper            | replaces (JAX package)                           |
|--------------------|--------------------------------------------------|
| ell_spmv           | ops/linop.py:123-127 EllOp.matvec / rmatvec      |
| coo_spmv           | ops/linop.py:81-90 CooOp.matvec / rmatvec        |
|   (_batch: K14b)   |   the same over B rows, the operator shared      |
| linesearch_loop    | solver.py:436-482 the whole linesearch loop      |
| ls_dual_update     | solver.py:452-463 linesearch body + box proj.    |
| sq_dist            | solver.py:459-461 the accept test's norms        |
| residuals          | solver.py:545-612 _residuals_and_gap reductions  |
| primal_update_sym  | solver.py:308 + ops/cones.py:172-173             |
| soc_projection     | ops/cones.py:43-56 + solver.py:414-419 SOC proj. |
|   (_batch: K13b)   |   the same for every instance, a gap each        |
| ns_gemm            | ops/cones.py:84-95, 285-297 the polar products   |
| fro_scale          | ops/cones.py:85-86, 279-284 Frobenius scaling    |
| sym                | ops/cones.py:94, 292 S = (Y + Y^T) / 2           |
| sym_guard          | ops/cones.py:96-109, 294-310 Xp, guard and rank  |
| cholqr             | ops/cones.py:243-263 one CholeskyQR pass         |
| ritz_accept        | ops/cones.py:443-489 the Ritz acceptance test    |
| subspace_sign      | ops/cones.py:349-410 the sign-based step's k x k |
|                    |   work and acceptance test (f32 only)            |
| psd_reconstruct    | ops/cones.py:204-211, 223-232 the dense-eigh     |
|                    |   reconstruction V diag(w+) V^T (rows r0..r1)    |
| lanczos_krylov     | ops/lanczos.py:56-95 the Lanczos recurrence      |
| batched_psd_eigh   | ops/cones.py:622-675, 204-211 batched eigh proj. |
|   (_large: K9L)    |   the same past one block's shared memory        |
| batched_subspace   | ops/cones.py:427-510 accept-always subspace step |
|   (_large: K12L)   |   the same on a device-memory working set        |
| ns_gemm_batch      | ops/cones.py:84-95 polar_psd's products, vmapped |
| fro_scale_batch,   | ops/cones.py:85-86, 94, 96-109 vmapped: scaling, |
| sym(_guard)_batch  |   S and the guard of each instance               |
| tri_to_square      | ops/tri.py:39-44 (batched)                       |
| square_to_tri      | ops/tri.py:47-52 (batched)                       |
| batched_gemv(_t)   | ops/linop.py:44-48 DenseOp products, vmapped     |
| control (_batch)   | solver.py:563-637 the residual formulas and ring |
|                    |   writes, 653-807 _control's decisions (K19)     |
| restart_average    | solver.py:809-860 the running sums and the       |
|   (_batch: K20a)   |   restart test's reductions over their average   |
| restart_adopt      | solver.py:862-897 the jump to the average (K20b) |
|   (_batch)         |                                                  |
| freeze_rows        | parallel/batch.py:149-155 the masked freeze (K21)|

The batch driver (``parallel/batch.py``) runs K1, K3, K4, K13, K14 and
the linesearch loop through their ``*_batch`` entry points: a leading
instance axis on every vector, per-instance step scalars as (B,) tensors and
per-instance b, h, c, one launch per batch.  K1's and the linesearch
loop's batched entry points take one operator for every instance or one
per instance (stacked ELL values or dense matrices, a value stride in the
kernel; ``per_instance_launches`` counts those launches apart), and
``batched_gemv`` (K16) is the per-instance dense operator's M x
(``batched_gemv_t`` its M' y, which the linesearch loop computes itself).

The linesearch loop (K15, K15b) runs every trial of one iteration's
Malitsky-Pock linesearch in one launch.  One trial's kernels, K2
(``ls_dual_update``) and ``sq_dist``, are not on the solve path any more:
the fixed-step dual update (``line_search_flag=False``) runs K2, and the
plain loops (``linesearch_loop_plain``, ``linesearch_loop_batch_plain``)
call K2, the operator's product and ``sq_dist`` once a trial -- on the
CPU the plain versions, on the card the kernels, the sequence K15
replaces and is held to.

The f32 and f64 instantiations share one source each; ``fro_scale`` and
``sym_guard`` also take the mixed f64/f32 pairs of the f64 program's
f32-compute polar reseed, ``batched_subspace`` the mixed f64 step with an
f32 basis ("f64_f32").
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..ops.cones import POLAR_QA, POLAR_QB, POLAR_QC, box_projection
from ..utils.vech import offdiag_mask_tri, square_gather_index, tri_ij
from . import build
from .build import KernelError

# the single-instance solve's kernels, the batch driver's, and one
# linesearch trial's (the plain loops' parts; K2 and K16's M' y also the
# fixed step's)
SOLVE_KERNELS = ("ell_spmv", "linesearch_loop", "residuals",
                 "primal_update_sym", "ns_gemm", "fro_scale", "sym",
                 "sym_guard", "cholqr", "ritz_accept", "lanczos_krylov",
                 "soc_projection", "coo_spmv", "subspace_sign",
                 "psd_reconstruct", "control", "restart_average",
                 "restart_adopt")
BATCH_KERNELS = ("ell_spmv_batch", "linesearch_loop_batch", "residuals_batch",
                 "primal_update_batch", "batched_psd_eigh", "tri_to_square",
                 "square_to_tri", "batched_subspace", "batched_gemv",
                 "batched_psd_eigh_large", "batched_subspace_large",
                 "ns_gemm_batch", "fro_scale_batch", "sym_batch",
                 "sym_guard_batch", "soc_projection_batch", "coo_spmv_batch",
                 "control_batch", "restart_average_batch",
                 "restart_adopt_batch", "freeze_rows")
TRIAL_KERNELS = ("ls_dual_update", "sq_dist", "ls_dual_update_batch",
                 "sq_dist_batch", "batched_gemv_t")
KERNELS = SOLVE_KERNELS + BATCH_KERNELS + TRIAL_KERNELS

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
_ARGTYPES = {
    "ell_spmv": [_P, _P, _P, _P, _I, _I, _P],
    "ls_dual_update": [_P] * 11 + [_I, _I, _P],
    "sq_dist": [_P, _P, _P, _P, _I, _P],
    "linesearch_loop": [_P] * 21 + [_I] * 6 + [_D, _D, _P],
    "linesearch_loop_batch": [_P] * 21 + [_I] * 8 + [_D, _D, _P],
    "residuals": [_P] * 18 + [_I] * 4 + [_P],
    "primal_update_sym": [_P] * 6 + [_I] * 3 + [_P],
    "soc_projection": [_P] * 3 + [_I] + [_P] * 3,
    "coo_spmv": [_P] * 5 + [_I, _P],
    "ns_gemm": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _D, _D, _P],
    "fro_scale": [_P] * 4 + [_I, _P],
    "sym": [_P, _P, _I, _P],
    "sym_guard": [_P] * 7 + [_I, _P],
    "cholqr": [_P, _P, _P, _I, _I, _D, _P],
    "ritz_accept": [_P] * 4 + [_I, _I, _D, _D, _I] + [_P] * 4,
    "subspace_sign": [_P] * 7 + [_I, _I, _D, _I, _I, _I, _P],
    "psd_reconstruct": [_P] * 3 + [_I] * 3 + [_P],
    "lanczos_krylov": [_P] * 6 + [_I, _I, _D, _P],
    "ell_spmv_batch": [_P] * 4 + [_I] * 5 + [_P],
    "ls_dual_update_batch": [_P] * 10 + [_I] * 3 + [_P],
    "sq_dist_batch": [_P] * 3 + [_I, _I, _P],
    "residuals_batch": [_P] * 14 + [_I] * 4 + [_P],
    "primal_update_batch": [_P] * 5 + [_I, _I, _P],
    "batched_psd_eigh": [_P] * 5 + [_I, _I, _D, _P],
    "tri_to_square": [_P] * 4 + [_I] * 3 + [_P],
    "square_to_tri": [_P] * 4 + [_I] * 3 + [_P],
    "batched_subspace": [_P, _I] + [_P] * 7 + [_I] * 3 + [_D] * 4 + [_P],
    "batched_gemv": [_P] * 3 + [_I] * 3 + [_P],
    "batched_gemv_t": [_P] * 3 + [_I] * 3 + [_P],
    "batched_psd_eigh_large": [_P] * 8 + [_I, _I, _D, _P],
    "batched_subspace_large": [_P, _I] + [_P] * 8 + [_I] * 4 + [_D] * 4 + [_P],
    "ns_gemm_batch": [_P, _I, _I] * 3 + [_P] + [_I] * 4 + [_D, _D, _P],
    "fro_scale_batch": [_P] * 3 + [_I, _I, _P],
    "sym_batch": [_P, _P, _I, _I, _P],
    "sym_guard_batch": [_P] * 7 + [_I, _I, _P],
    "soc_projection_batch": [_P, _I, _P, _P, _I, _I, _P, _P, _P],
    "coo_spmv_batch": [_P] * 4 + [_I, _P, _I, _I, _P],
    "control": [_P, _I, _P, _P] + [_I] * 6 + [_P],
    "control_batch": [_P, _I, _P, _P] + [_I] * 6 + [_P],
    "restart_average": [_P] * 16 + [_I] * 4 + [_P],
    "restart_average_batch": [_P] * 16 + [_I] * 4 + [_P],
    "restart_adopt": [_P] * 12 + [_I] * 3 + [_P],
    "restart_adopt_batch": [_P] * 12 + [_I] * 3 + [_P],
    "freeze_rows": [_P, _P, _I, _I, _P],
}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}
# entry points of mixed type pairs: (input, output) dtype suffixes
_MIXED = {"fro_scale": ("f64_f32",), "sym_guard": ("f32_f64",),
          "psd_reconstruct": ("f64_f32",),
          "batched_subspace": ("f64_f32",),
          "batched_subspace_large": ("f64_f32",)}
# entry points of one type only (freeze_rows copies 32-bit words, whatever
# the fields' dtypes)
_ONLY = {"subspace_sign": ("f32",), "freeze_rows": ("u32",)}


def _suffixes(name: str) -> tuple[str, ...]:
    if name in _ONLY:
        return _ONLY[name]
    return (*_SUFFIX.values(), *_MIXED.get(name, ()))


# launches by entry point, e.g. "residuals_f32", "sym_guard_f32_f64"
launch_counts = {f"{name}_{sfx}": 0 for name in KERNELS
                 for sfx in _suffixes(name)}


# the launches of ``residuals`` with a row scale (an equilibrated
# problem's), by dtype suffix; they also count in ``launch_counts``
row_scale_launches = {sfx: 0 for sfx in _SUFFIX.values()}

# the launches of K1's and the linesearch loop's batched entry points over
# per-instance operator values (a value stride > 0), by entry point; they
# also count in ``launch_counts``
PER_INSTANCE_KERNELS = ("ell_spmv_batch", "linesearch_loop_batch")
per_instance_launches = {f"{name}_{sfx}": 0 for name in PER_INSTANCE_KERNELS
                         for sfx in _SUFFIX.values()}


def reset_launch_counts() -> None:
    for counts in (launch_counts, row_scale_launches, per_instance_launches):
        for key in counts:
            counts[key] = 0


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


def _entry(name: str, dtype) -> tuple:
    """(name, the function ``proxsdp_{name}_{suffix}``, its launch_counts
    key); ``dtype`` is a torch dtype or an entry-point suffix such as
    "f64_f32"."""
    sfx = dtype if isinstance(dtype, str) else _SUFFIX[dtype]
    return name, getattr(_library(), f"proxsdp_{name}_{sfx}"), f"{name}_{sfx}"


def _call(entry: tuple, device: torch.device, *args) -> None:
    """Launch an ``_entry`` on the current stream of ``device``."""
    name, fn, key = entry
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise KernelError(f"{name}: CUDA launch failed (cudaError {rc})")
    launch_counts[key] += 1


def _launch(name: str, dtype, device: torch.device, *args):
    """Launch ``proxsdp_{name}_{suffix}`` (see ``_entry``)."""
    _call(_entry(name, dtype), device, *args)


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


# ---------------------------------------------- K14 COO (segmented) SpMV


def coo_spmv_plain(ptr, idx, vals, v, seg):
    return torch.zeros(ptr.shape[0] - 1, dtype=v.dtype,
                       device=v.device).index_add_(0, seg, vals * v[idx.long()])


def coo_spmv(ptr, idx, vals, v, seg):
    """out[s] = sum_{k in [ptr[s], ptr[s+1])} vals[k] * v[idx[k]]: ptr the
    int64 segment starts, idx int32 (in range), ``seg`` the int64 segment
    of each term (the plain version's scatter index)."""
    name = "coo_spmv"
    if (ptr.dtype != torch.int64 or idx.dtype != torch.int32
            or seg.dtype != torch.int64 or ptr.dim() != 1
            or idx.shape != vals.shape or seg.shape != vals.shape):
        raise ValueError(f"{name}: want int64 ptr and seg, int32 idx, and "
                         "one length for idx, vals and seg")
    if _on_cpu(name, ptr, idx, vals, v, seg):
        return coo_spmv_plain(ptr, idx, vals, v, seg)
    nseg = ptr.shape[0] - 1
    out = torch.empty(nseg, dtype=v.dtype, device=v.device)
    _launch(name, v.dtype, v.device, _ptr(ptr), _ptr(idx), _ptr(vals), _ptr(v),
            _ptr(out), nseg)
    return out


def coo_spmv_batch_plain(ptr, idx, vals, V, seg):
    # the rows' sums as coo_spmv_plain's: index_add_ adds the terms of a
    # segment in order, each column of the (nseg, B) sums on its own
    terms = vals[:, None] * V[:, idx.long()].T
    return torch.zeros(ptr.shape[0] - 1, V.shape[0], dtype=V.dtype,
                       device=V.device).index_add_(0, seg, terms).T.contiguous()


COO_BATCH_ROWS = 8  # coo_spmv.cu: rows of V a warp sums at once


def coo_spmv_batch(ptr, idx, vals, V, seg):
    """``coo_spmv`` of each row of V (B, ncols) over one operator's
    segments (K14b): out[i, s] = sum_{k in [ptr[s], ptr[s+1])} vals[k] *
    V[i, idx[k]], (B, nseg); each row K14's bit for bit."""
    name = "coo_spmv_batch"
    if (ptr.dtype != torch.int64 or idx.dtype != torch.int32
            or seg.dtype != torch.int64 or ptr.dim() != 1
            or idx.shape != vals.shape or seg.shape != vals.shape):
        raise ValueError(f"{name}: want int64 ptr and seg, int32 idx, and "
                         "one length for idx, vals and seg")
    if V.dim() != 2 or -(-V.shape[0] // COO_BATCH_ROWS) > 65535:
        raise ValueError(f"{name}: want a 2-d V of at most "
                         f"{65535 * COO_BATCH_ROWS} rows")
    if _on_cpu(name, ptr, idx, vals, V, seg):
        return coo_spmv_batch_plain(ptr, idx, vals, V, seg)
    B, nseg = V.shape[0], ptr.shape[0] - 1
    out = torch.empty((B, nseg), dtype=V.dtype, device=V.device)
    _launch(name, V.dtype, V.device, _ptr(ptr), _ptr(idx), _ptr(vals), _ptr(V),
            V.shape[1], _ptr(out), nseg, B)
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


# ------------------------------------------ K15 the linesearch's trial loop

# ls_loop.cu's operator forms
LS_ELL, LS_COO, LS_DENSE = 0, 1, 2


def _rmatvec_form(name: str, M, rows: int, n: int):
    """M.rmatvec_tables() of a port operator (ops.linop): (form, ptr, idx,
    vals, width) -- ELL's column tables, COO's column segments or the
    dense matrix -- after a check of its shape."""
    if tuple(M.shape) != (rows, n):
        raise ValueError(f"{name}: operator of shape {tuple(M.shape)}, want "
                         f"({rows}, {n})")
    return M.rmatvec_tables()


def linesearch_loop_plain(M, y, Mx, Mx_old, b, h, y_old, Mty_old, tau,
                          tau_old, theta, beta, p: int, m: int, delta: float,
                          decay: float, max_steps: int, decide=bool):
    ps = tau * torch.sqrt(1.0 + theta)
    sqrt_beta = torch.sqrt(beta)
    y_temp, Mty, trials = torch.zeros_like(y), torch.zeros_like(Mty_old), 0
    for _ in range(max_steps):
        theta = ps / tau_old
        y_temp, dy = ls_dual_update(y, Mx, Mx_old, b, h, y_old, beta * ps,
                                    theta, p, m)
        Mty = M.rmatvec(y_temp)
        dM = sq_dist(Mty, Mty_old)
        trials += 1
        # one host read a trial (``decide``: a tensor-parallel solve takes
        # rank 0's)
        if decide(sqrt_beta * ps * torch.sqrt(dM) <= delta * torch.sqrt(dy)):
            break
        ps = ps * decay
    return (y_temp, Mty, theta, ps,
            torch.tensor(trials, dtype=torch.int32, device=y.device))


def linesearch_loop(M, y, Mx, Mx_old, b, h, y_old, Mty_old, tau, tau_old,
                    theta, beta, p: int, m: int, delta: float, decay: float,
                    max_steps: int):
    """The Malitsky-Pock linesearch of one iteration (solver.py:436-482):
    from ps = tau sqrt(1 + theta), trials of K2's dual update, Mty = M'
    y_temp and the accept test sqrt(beta) ps ||Mty - Mty_old|| <= delta
    ||y_temp - y_old||, ps *= decay after each refused one, at most
    ``max_steps`` (>= 1) trials.  ``M`` is the port's operator (ELL, COO or
    dense); tau, tau_old, theta and beta are 0-d.  Returns (y_temp, Mty,
    theta, ps, trials): the last trial's y_temp, Mty and theta, the final
    ps, and the trial count (0-d int32).  One launch on the card (no host
    read); on the CPU the plain loop, one host read a trial."""
    name = "linesearch_loop"
    rows, n = p + m, Mty_old.shape[0]
    if M.batched:
        raise ValueError(f"{name}: a per-instance operator (stacked values) "
                         "needs linesearch_loop_batch")
    form, ptr, idx, vals, width = _rmatvec_form(name, M, rows, n)
    for t, what in ((y, "y"), (Mx, "Mx"), (Mx_old, "Mx_old"), (y_old, "y_old")):
        _check_vec(name, t, rows, what)
    _check_vec(name, b, p, "b")
    _check_vec(name, h, m, "h")
    for t, what in ((tau, "tau"), (tau_old, "tau_old"), (theta, "theta"),
                    (beta, "beta")):
        _check_scalar(name, t, what)
    if max_steps < 1 or (rows < 1 and form == LS_ELL):
        raise ValueError(f"{name}: want max_steps >= 1 and an ELL operator "
                         f"with rows, got {max_steps} steps and {rows} rows")
    if _on_cpu(name, y, Mx, Mx_old, b, h, y_old, Mty_old, tau, tau_old, theta,
               beta, vals):
        return linesearch_loop_plain(M, y, Mx, Mx_old, b, h, y_old, Mty_old,
                                     tau, tau_old, theta, beta, p, m, delta,
                                     decay, max_steps)
    dev, dt = y.device, y.dtype
    y_temp, Mty = torch.empty_like(y), torch.empty_like(Mty_old)
    theta_out, ps_out = torch.empty_like(theta), torch.empty_like(tau)
    trials = torch.empty((), dtype=torch.int32, device=dev)
    part_y = torch.empty(_reduce_grid(rows), dtype=dt, device=dev)
    part_m = torch.empty(_reduce_grid(n), dtype=dt, device=dev)
    _launch(name, dt, dev, *map(_ptr, (y, Mx, Mx_old, b, h, y_old, Mty_old,
                                       tau, tau_old, theta, beta)),
            None if ptr is None else _ptr(ptr),
            None if idx is None else _ptr(idx), _ptr(vals),
            *map(_ptr, (y_temp, Mty, theta_out, ps_out, trials, part_y,
                        part_m)),
            p, m, n, width, form, int(max_steps), float(delta), float(decay))
    return y_temp, Mty, theta_out, ps_out, trials


# ------------------------------------------------------------ K3 residuals

RESIDUAL_SLOTS = 9


def _offsets(lens) -> np.ndarray:
    """Start offsets of blocks of ``lens`` laid end to end from 0, and the
    end of the last (len(lens) + 1 int64 values)."""
    return np.concatenate([[0], np.cumsum(lens, dtype=np.int64)]).astype(np.int64)


def _square_lens(sides) -> tuple:
    return tuple(int(s) * int(s) for s in sides)


@functools.lru_cache(maxsize=32)
def _block_table(sides: tuple, device) -> tuple:
    """residuals.cu's table of square blocks laid end to end from offset
    0: (offsets (nblk + 1,), sides (nblk,)), int64 on ``device``; (None,
    None) without blocks."""
    if not sides:
        return None, None
    return (torch.tensor(_offsets(_square_lens(sides)), device=device),
            torch.tensor(sides, dtype=torch.int64, device=device))


@functools.lru_cache(maxsize=32)
def _offdiag_weight(n: int, sides: tuple, dtype, device) -> torch.Tensor:
    """sqrt(2) on the off-diagonal positions of the square blocks of
    ``sides`` laid end to end from offset 0, 1 elsewhere (length n)."""
    w = np.ones(n)
    for off, side in zip(_offsets(_square_lens(sides)), sides):
        q = np.arange(side * side)
        w[off : off + side * side][q // side != q % side] = math.sqrt(2.0)
    return torch.tensor(w, dtype=dtype, device=device)


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
                    b, h, c, p: int, m: int, sides: tuple, row_scale=None):
    w = _offdiag_weight(x.shape[0], tuple(sides), x.dtype, x.device)
    px_old = x_old - tau * Mty_old
    px = x - tau * Mty
    py_old = y_old - sigma * Mx_old
    py = y - sigma * Mx
    r_eq, r_in = Mx[:p] - b, Mx[p:] - h
    if row_scale is not None:
        r_eq, r_in = r_eq * row_scale[:p], r_in * row_scale[p:]
    ineq = (torch.amax(r_in) if m
            else torch.tensor(-math.inf, dtype=x.dtype, device=x.device))
    maxima = torch.stack([
        _max_abs((px - px_old) * w),
        _max_abs(px_old * w),
        _max_abs(py - py_old),
        _max_abs(py_old),
        _max_abs(r_eq),
        ineq,
    ]).double()
    if x.dtype == torch.float64:
        dots = [torch.dot(c, x), torch.dot(b, y[:p]), torch.dot(h, y[p:])]
    else:
        dots = [_chunk_dot(c, x), _chunk_dot(b, y[:p]), _chunk_dot(h, y[p:])]
    return torch.cat([maxima, torch.stack(dots)])


def residuals(x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma,
              b, h, c, p: int, m: int, sides: tuple, row_scale=None,
              fold: bool = True):
    """The nine reductions of residuals.cu (see its header) as a (9,) f64
    tensor.  ``sides``: the square PSD blocks laid end to end from offset
    0 of x (their off-diagonal entries weigh sqrt(2) in the x-space
    maxima); ``row_scale``: None or the (p + m,) scale of the equality and
    inequality residuals (an equilibrated problem's 1/E).  For f32 inputs
    the maxima are f32 values and the dots two-stage sums.  ``fold=False``
    skips the second pass on the card and returns pass 1's (P, 9) f64
    partials, which K19 (``control``) folds in the same order."""
    name = "residuals"
    n = x.shape[0]
    sides = tuple(int(s) for s in sides)
    for t, what in ((x, "x"), (x_old, "x_old"), (Mty, "Mty"),
                    (Mty_old, "Mty_old"), (c, "c")):
        _check_vec(name, t, n, what)
    for t, what in ((y, "y"), (y_old, "y_old"), (Mx, "Mx"), (Mx_old, "Mx_old")):
        _check_vec(name, t, p + m, what)
    _check_vec(name, b, p, "b")
    _check_vec(name, h, m, "h")
    _check_scalar(name, tau, "tau")
    _check_scalar(name, sigma, "sigma")
    if sum(_square_lens(sides)) > n:
        raise ValueError(f"{name}: the size of blocks of sides {sides} "
                         f"exceeds n={n}")
    args = (x, x_old, Mty, Mty_old, tau, y, y_old, Mx, Mx_old, sigma, b, h, c)
    extra = ()
    if row_scale is not None:
        _check_vec(name, row_scale, p + m, "row_scale")
        extra = (row_scale,)
    if _on_cpu(name, *args, *extra):
        return residuals_plain(*args, p, m, sides, row_scale)
    if x.dtype == torch.float64:
        grid = _reduce_grid(max(n, p + m))
    else:  # residuals.cu:f32_grid, one warp per 128-element chunk
        chunks = sum(-(-k // DOT_CHUNK) for k in (n, p, m))
        grid = _reduce_grid(32 * chunks)
    partials = torch.empty(grid * RESIDUAL_SLOTS, dtype=torch.float64,
                           device=x.device)
    out = (torch.empty(RESIDUAL_SLOTS, dtype=torch.float64, device=x.device)
           if fold else None)
    offs, sds = _block_table(sides, x.device)
    _launch(name, x.dtype, x.device, *map(_ptr, args),
            None if row_scale is None else _ptr(row_scale),
            None if offs is None else _ptr(offs),
            None if sds is None else _ptr(sds), _ptr(partials),
            _ptr(out) if fold else None, n, p, m, len(sides))
    if row_scale is not None:
        row_scale_launches[_SUFFIX[x.dtype]] += 1
    return out if fold else partials.view(grid, RESIDUAL_SLOTS)


# ------------------------------------------ K4 primal update + symmetrise


def _runs(sides: tuple):
    """(offset, side, count) of each run of equal consecutive sides of
    square blocks laid end to end from offset 0."""
    runs, off = [], 0
    for side in sides:
        if runs and runs[-1][1] == side:
            runs[-1][2] += 1
        else:
            runs.append([off, side, 1])
        off += side * side
    return [tuple(r) for r in runs]


def primal_update_sym_plain(x, Mty, c, tau, sides: tuple):
    u = x - tau * (Mty + c)
    parts, end = [], 0
    for off, side, cnt in _runs(tuple(sides)):
        X = u[off : off + cnt * side * side].view(cnt, side, side)
        parts.append((0.5 * (X + X.transpose(1, 2))).reshape(-1))
        end = off + cnt * side * side
    return torch.cat(parts + [u[end:]]) if parts else u


SYM_TILE = 32  # primal_update_sym.cu's tile


@functools.lru_cache(maxsize=32)
def _tile_table(sides: tuple, device) -> torch.Tensor:
    """primal_update_sym.cu's tiles: (ntiles, 4) int64 rows (block offset,
    side, first row, first column) of every 32 x 32 tile of every block."""
    rows = []
    for off, side in zip(_offsets(_square_lens(sides)), sides):
        nt = -(-side // SYM_TILE)
        rows += [(int(off), side, SYM_TILE * i, SYM_TILE * j)
                 for i in range(nt) for j in range(nt)]
    return torch.tensor(rows, dtype=torch.int64,
                        device=device).reshape(-1, 4)


def primal_update_sym(x, Mty, c, tau, sides: tuple):
    """u = x - tau*(Mty + c) with each square block of ``sides`` (laid end
    to end from offset 0) symmetrised; one launch."""
    name = "primal_update_sym"
    n = x.shape[0]
    sides = tuple(int(s) for s in sides)
    _check_vec(name, Mty, n, "Mty")
    _check_vec(name, c, n, "c")
    _check_scalar(name, tau, "tau")
    start = sum(_square_lens(sides))
    if start > n:
        raise ValueError(f"{name}: the size of blocks of sides {sides} "
                         f"exceeds n={n}")
    if _on_cpu(name, x, Mty, c, tau):
        return primal_update_sym_plain(x, Mty, c, tau, sides)
    out = torch.empty_like(x)
    tiles = _tile_table(sides, x.device)
    _launch(name, x.dtype, x.device, _ptr(x), _ptr(Mty), _ptr(c), _ptr(tau),
            _ptr(out), _ptr(tiles), tiles.shape[0], start, n)
    return out


# ------------------------------------- K13 second-order-cone projection


def _warp_sq_norms(V):
    """Sums of squares of the rows of V (G, L) in soc_proj.cu's order:
    lane l adds v_l^2, v_{l+32}^2, ... in turn, then a shuffle tree folds
    the lanes 16, 8, 4, 2, 1 apart."""
    G, L = V.shape
    if L == 0:
        return V.new_zeros(G)
    sq = V * V
    pad = (-L) % 32
    if pad:
        sq = torch.cat([sq, sq.new_zeros(G, pad)], dim=1)
    sq = sq.view(G, -1, 32)
    acc = sq[:, 0]
    for r in range(1, sq.shape[1]):
        acc = acc + sq[:, r]
    for half in (16, 8, 4, 2, 1):
        acc = acc[:, :half] + acc[:, half : 2 * half]
    return acc[:, 0]


@functools.lru_cache(maxsize=32)
def _soc_groups(lens: tuple, device):
    """(length, (G, length) int64 gather index) per distinct block length
    of SOC blocks laid end to end from 0."""
    starts: dict = {}
    for off, ln in zip(_offsets(lens), lens):
        starts.setdefault(ln, []).append(int(off))
    return [(ln, (torch.tensor(st, device=device)[:, None]
                  + torch.arange(ln, device=device)))
            for ln, st in starts.items()]


def soc_projection_plain(v, lens: tuple):
    out, gap = soc_projection_batch_plain(v[None], lens)
    return out[0], gap[0]


SOC_WARPS = 8  # soc_proj.cu: blocks per CTA


def soc_projection(v, lens: tuple):
    """(proj, gap): every SOC block [s, v_1..] of ``lens`` (a tuple, laid
    end to end in v) projected onto ||v|| <= s, and gap = max over blocks
    of ||v'|| - s' of the projected blocks (0-d, v's dtype)."""
    name = "soc_projection"
    offs, total = _soc_table(tuple(lens), v.device)
    _check_vec(name, v, total, "v")
    if _on_cpu(name, v):
        return soc_projection_plain(v, lens)
    grid = min(-(-len(lens) // SOC_WARPS), 1024)
    out = torch.empty_like(v)
    partials = torch.empty(grid, dtype=v.dtype, device=v.device)
    gap = torch.empty((), dtype=v.dtype, device=v.device)
    _launch(name, v.dtype, v.device, _ptr(v), _ptr(out), _ptr(offs), len(lens),
            _ptr(partials), _ptr(gap))
    return out, gap


def soc_projection_batch_plain(V, lens: tuple):
    B = V.shape[0]
    out = torch.empty_like(V)
    gaps = []
    for ln, idx in _soc_groups(tuple(lens), V.device):
        blk = V[:, idx].reshape(-1, ln)  # (B * G, ln), instance-major
        s, W = blk[:, 0], blk[:, 1:]
        nv = torch.sqrt(_warp_sq_norms(W))
        scale = 0.5 * (1.0 + s / torch.where(nv == 0, 1.0, nv))
        in_cone, in_polar = nv <= s, nv <= -s
        new_s = torch.where(in_polar, 0.0, torch.where(in_cone, s, scale * nv))
        f = torch.where(in_polar, 0.0, torch.where(in_cone, 1.0, scale))
        new_v = f[:, None] * W
        out[:, idx] = torch.cat([new_s[:, None], new_v], dim=1).view(
            B, -1, ln)
        gaps.append(torch.amax((torch.sqrt(_warp_sq_norms(new_v)) - new_s)
                               .view(B, -1), dim=1))
    return out, torch.amax(torch.stack(gaps, dim=1), dim=1)


def soc_projection_batch(V, lens: tuple):
    """``soc_projection`` of each row of V (B, total), one launch (K13b):
    (proj (B, total), gap (B,)), each row K13's bit for bit.  V's rows may
    have a stride (a column slice of the batch's iterate)."""
    name = "soc_projection_batch"
    offs, total = _soc_table(tuple(lens), V.device)
    if V.dim() != 2 or V.shape[1] != total or V.shape[0] > 65535:
        raise ValueError(f"{name}: V has shape {tuple(V.shape)}, want (B <= "
                         f"65535, {total})")
    if V.stride(1) != 1:
        raise ValueError(f"{name}: V's columns must be contiguous")
    if _on_cpu(name, V, strided=True):
        return soc_projection_batch_plain(V, lens)
    B = V.shape[0]
    grid = min(-(-len(lens) // SOC_WARPS), 1024)
    out = torch.empty((B, total), dtype=V.dtype, device=V.device)
    partials = torch.empty(B * grid, dtype=V.dtype, device=V.device)
    gap = torch.empty(B, dtype=V.dtype, device=V.device)
    _launch(name, V.dtype, V.device, _ptr(V), V.stride(0), _ptr(out),
            _ptr(offs), len(lens), B, _ptr(partials), _ptr(gap))
    return out, gap


@functools.lru_cache(maxsize=32)
def _soc_table(lens: tuple, device):
    """(soc_proj.cu's int64 offsets on ``device``, the blocks' total
    length), checked once per block list."""
    if not lens or min(lens) < 1:
        raise ValueError("soc_projection: want SOC blocks of length >= 1")
    return torch.tensor(_offsets(lens), device=device), int(sum(lens))


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


# ------------------------- K5b, K6b: the polar projection of a batch


def _check_stack(name: str, t: torch.Tensor, what: str) -> None:
    """3-d with contiguous rows (a stride per instance and per row)."""
    if t.dim() != 3 or (t.shape[2] > 1 and t.stride(2) != 1):
        raise ValueError(f"{name}: {what} must be 3-d with contiguous rows")


def _instance_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1] * t.shape[2]


def ns_gemm_batch_plain(A, B, C=None, alpha: float = 0.0, beta: float = 1.0):
    prod = beta * torch.matmul(A, B)
    return prod if C is None else alpha * C + prod


def ns_gemm_batch(A, B, C=None, alpha: float = 0.0, beta: float = 1.0):
    """``ns_gemm`` of each instance of a batch, one launch: out[z] = alpha *
    C[z] + beta * (A[z] @ B[z]) for (nb, M, K) A, (nb, K, N) B, (nb, M, N)
    C (or None), a new contiguous (nb, M, N) tensor; each instance rounded
    as ``ns_gemm`` rounds it."""
    name = "ns_gemm_batch"
    mats = (A, B) if C is None else (A, B, C)
    for t, what in zip(mats, ("A", "B", "C")):
        _check_stack(name, t, what)
    nb, M, K = A.shape
    N = B.shape[2]
    if (B.shape[:2] != (nb, K)
            or (C is not None and C.shape != (nb, M, N))):
        raise ValueError(f"{name}: shapes {tuple(A.shape)} @ {tuple(B.shape)}"
                         f" + {None if C is None else tuple(C.shape)}")
    if _on_cpu(name, *mats, strided=True):
        return ns_gemm_batch_plain(A, B, C, alpha, beta)
    out = torch.empty((nb, M, N), dtype=A.dtype, device=A.device)
    if out.numel() == 0:
        return out
    _launch(name, A.dtype, A.device,
            _ptr(A), A.stride(1) if M > 1 else K, _instance_stride(A),
            _ptr(B), B.stride(1) if K > 1 else N, _instance_stride(B),
            None if C is None else _ptr(C),
            0 if C is None else (C.stride(1) if M > 1 else N),
            0 if C is None else _instance_stride(C),
            _ptr(out), M, N, K, nb, float(alpha), float(beta))
    return out


def fro_scale_batch_plain(X):
    s = torch.sqrt(torch.sum(X * X, dim=(1, 2))) + 1e-30
    return X / s[:, None, None]


def fro_scale_batch(X):
    """Y[z] = X[z] / (||X[z]||_F + 1e-30) for each (s, s) instance of X, in
    X's type (polar_psd's scaling, vmapped)."""
    name = "fro_scale_batch"
    if X.dim() != 3:
        raise ValueError(f"{name}: X must be (B, s, s)")
    if _on_cpu(name, X):
        return fro_scale_batch_plain(X)
    nb, n = X.shape[0], X.shape[1] * X.shape[2]
    Y = torch.empty_like(X)
    if nb == 0:
        return Y
    partials = torch.empty(nb * _reduce_grid(n), dtype=X.dtype,
                           device=X.device)
    _launch(name, X.dtype, X.device, _ptr(X), _ptr(partials), _ptr(Y), n, nb)
    return Y


def sym_batch_plain(Y):
    return 0.5 * (Y + Y.transpose(1, 2))


def sym_batch(Y):
    """S[z] = 0.5 * (Y[z] + Y[z]^T) for (B, s, s) Y."""
    name = "sym_batch"
    if Y.dim() != 3 or Y.shape[1] != Y.shape[2]:
        raise ValueError(f"{name}: Y must be (B, s, s)")
    if _on_cpu(name, Y):
        return sym_batch_plain(Y)
    S = torch.empty_like(Y)
    if Y.shape[0]:
        _launch(name, Y.dtype, Y.device, _ptr(Y), _ptr(S), Y.shape[1],
                Y.shape[0])
    return S


def sym_guard_batch_plain(P, S, X):
    side = X.shape[1]
    Xp = 0.5 * (P + P.transpose(1, 2))
    bad = ~torch.all(torch.isfinite(Xp).flatten(1), dim=1)
    tr = torch.diagonal(S, dim1=1, dim2=2).sum(-1)
    rank = torch.clamp(torch.round(0.5 * (side + tr)), 0, side)
    return (torch.where(bad[:, None, None], X, Xp),
            torch.where(bad, side, rank).to(torch.int32), bad)


def sym_guard_batch(P, S, X):
    """``sym_guard`` of each instance: (Xp (B, s, s), rank (B,) int32, bad
    (B,) bool); an instance whose Xp has a non-finite value gets X and
    rank = s, the others clip(round((s + tr S) / 2), 0, s)."""
    name = "sym_guard_batch"
    if X.dim() != 3 or X.shape[1] != X.shape[2]:
        raise ValueError(f"{name}: X must be (B, s, s)")
    for t, what in ((P, "P"), (S, "S")):
        if t.shape != X.shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"want {tuple(X.shape)}")
    if _on_cpu(name, P, S, X):
        return sym_guard_batch_plain(P, S, X)
    nb, side = X.shape[0], X.shape[1]
    nt = -(-side // 32)
    flags = torch.empty(max(nb, 1) * nt * nt, dtype=torch.int32,
                        device=X.device)
    Xp = torch.empty_like(X)
    rank = torch.empty(nb, dtype=torch.int32, device=X.device)
    bad = torch.empty(nb, dtype=torch.bool, device=X.device)
    if nb:
        _launch(name, X.dtype, X.device, _ptr(P), _ptr(S), _ptr(X), _ptr(Xp),
                _ptr(flags), _ptr(rank), _ptr(bad), side, nb)
    return Xp, rank, bad


# -------------------------------------------------------- K7 CholeskyQR

# the jitter of _cholqr2, keyed on the compute dtype (cones.py:249-256)
CHOLQR_EPS = {torch.float32: 1e-6, torch.float64: 1e-12}
# shared memory for G (k * k words) in cholqr.cu's single block; a larger
# G goes to a scratch in device memory
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
    gws = (torch.empty((k, k), dtype=Y.dtype, device=Y.device)
           if k * k * Y.element_size() > CHOLQR_SMEM_BYTES else None)
    Q = torch.empty_like(Y)
    _launch(name, Y.dtype, Y.device, _ptr(Y), _ptr(Q),
            None if gws is None else _ptr(gws), side, k, float(eps))
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


# ------------------------------------- K17 sign-based subspace step

# subspace_sign.cu keeps its four k x k matrices in shared memory to this
# k, above it in a device workspace
SIGN_SMEM_MAX_K = 64


def subspace_sign_plain(Q, Z, accept_tol, subspace_tol: float,
                        aggressive: int, polish: int, force_full: bool):
    k = Q.shape[1]
    eye = torch.eye(k, dtype=Q.dtype, device=Q.device)
    B = Q.T @ Z
    B = 0.5 * (B + B.T)
    sF = torch.sqrt(torch.sum(B * B)) + 1e-30
    Y = B / sF
    for _ in range(aggressive):
        A2 = Y @ Y
        Y = POLAR_QA * Y + Y @ (POLAR_QB * A2 + POLAR_QC * (A2 @ A2))
    for _ in range(polish):
        Y = 1.5 * Y - 0.5 * (Y @ (Y @ Y))
    S = 0.5 * (Y + Y.T)
    npos = 0.5 * (k + torch.trace(S))
    Pp = 0.5 * (eye + S)
    R = (Z - Q @ B) @ Pp
    rfro = torch.sqrt(torch.sum(R * R))
    scale = torch.clamp_min(sF, 1.0)
    thresh = torch.tensor(subspace_tol, dtype=Q.dtype, device=Q.device)
    if accept_tol is not None:
        thresh = torch.maximum(thresh, accept_tol)
    sign_err = torch.sqrt(torch.sum((S @ S - eye) ** 2))
    conv = ((rfro <= thresh * scale) & ((k - npos) >= 0.5)
            & (sign_err <= 0.05 * torch.sqrt(
                torch.tensor(k, dtype=Q.dtype, device=Q.device)))
            & (not force_full))
    stats = torch.stack([rfro / scale, npos - k, npos])
    Bp = 0.5 * (B + S @ B)
    Bp = 0.5 * (Bp + Bp.T)
    rank = torch.where(torch.isfinite(npos),
                       torch.clamp(torch.round(npos), 0, k), 0.0)
    info = torch.stack([conv.to(torch.int32), rank.to(torch.int32),
                        (~torch.all(torch.isfinite(B))).to(torch.int32)])
    return Bp, stats, info


def subspace_sign(Q, Z, accept_tol, subspace_tol: float, aggressive: int,
                  polish: int, force_full: bool):
    """(Bp, stats, info) of a sign-based subspace step (see
    subspace_sign.cu): Q the (side, k) CholeskyQR2 basis, Z = X Q, both
    f32; accept_tol a 0-d f32 tensor or None; Bp (k, k) = sym((B + sign(B)
    B) / 2) for B = sym(Q^T Z), stats = PsdProjResult.sub_stats [rfro /
    scale, npos - k, npos], info = int32 [conv_ok, rank, B non-finite]."""
    name = "subspace_sign"
    if Q.dim() != 2 or Z.shape != Q.shape:
        raise ValueError(f"{name}: Q and Z must be one (side, k) shape")
    side, k = Q.shape
    extra = []
    if accept_tol is not None:
        _check_scalar(name, accept_tol, "accept_tol")
        extra = [accept_tol]
    cpu = _on_cpu(name, Q, Z, *extra)
    if Q.dtype != torch.float32:
        raise TypeError(f"{name}: f32 only (the sign body's gate)")
    if cpu:
        return subspace_sign_plain(Q, Z, accept_tol, subspace_tol, aggressive,
                                   polish, force_full)
    if k > SUBSPACE_LARGE_MAX_K:
        raise ValueError(f"{name}: k = {k} > {SUBSPACE_LARGE_MAX_K}")
    dev = Q.device
    ws = (torch.empty(4 * k * k, dtype=torch.float32, device=dev)
          if k > SIGN_SMEM_MAX_K else None)
    Bp = torch.empty((k, k), dtype=torch.float32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)
    info = torch.empty(3, dtype=torch.int32, device=dev)
    _launch(name, torch.float32, dev, _ptr(Q), _ptr(Z),
            None if accept_tol is None else _ptr(accept_tol),
            None if ws is None else _ptr(ws), _ptr(Bp), _ptr(stats),
            _ptr(info), side, k, float(subspace_tol), int(aggressive),
            int(polish), int(bool(force_full)))
    return Bp, stats, info


# ---------------------------------- K18 dense-eigh PSD reconstruction


def psd_reconstruct_plain(V, w, r0: int, r1: int, out_dtype=None):
    Xp = torch.matmul(V * torch.clamp_min(w, 0.0)[None, :], V.T)[r0:r1]
    return Xp.to(out_dtype or V.dtype)


def psd_reconstruct(V, w, r0: int, r1: int, out_dtype=None):
    """Rows [r0, r1) of V diag(max(w, 0)) V^T for a dense eigh's V (n, n)
    and w (n,), computed in V's dtype and cast to ``out_dtype`` (default
    V's; f64 eigenpairs may go to an f32 block): a new contiguous (r1 -
    r0, n) tensor.  Each row equals that row of the whole product (see
    psd_reconstruct.cu).  V may have any strides (an eigh returns it
    column-major): the kernel reads a row-major copy."""
    name = "psd_reconstruct"
    n = V.shape[0]
    out_dtype = out_dtype or V.dtype
    if V.dim() != 2 or V.shape != (n, n):
        raise ValueError(f"{name}: V has shape {tuple(V.shape)}, want (n, n)")
    _check_vec(name, w, n, "w")
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"{name}: rows [{r0}, {r1}) outside [0, {n})")
    if _on_cpu(name, V, w, strided=True):
        return psd_reconstruct_plain(V, w, r0, r1, out_dtype)
    V, w = V.contiguous(), w.contiguous()
    if out_dtype == V.dtype:
        sfx = _SUFFIX[V.dtype]
    elif (V.dtype, out_dtype) == (torch.float64, torch.float32):
        sfx = "f64_f32"
    else:
        raise TypeError(f"{name}: {V.dtype} -> {out_dtype} not supported")
    out = torch.empty((r1 - r0, n), dtype=out_dtype, device=V.device)
    if out.numel() == 0:  # a rank that owns no rows
        return out
    _launch(name, sfx, V.device, _ptr(V), _ptr(w), _ptr(out), n, r0, r1 - r0)
    return out


# ------------------------------------------- K11 Lanczos recurrence

LANCZOS_CHUNK = 256  # lanczos.cu: the vector chunk of its reductions


def lanczos_krylov_plain(X, v0, ncv: int, tol: float):
    n = X.shape[0]
    dt = X.dtype
    eps = 1e-30
    nrm = torch.sqrt(torch.sum(v0 * v0))
    e0 = torch.zeros(n, dtype=dt, device=X.device)
    e0[0] = 1.0
    q = torch.where(nrm > eps, v0 / torch.where(nrm > eps, nrm, 1.0), e0)
    V = torch.zeros((ncv, n), dtype=dt, device=X.device)
    alphas, betas = [], []
    beta_prev = torch.zeros((), dtype=dt, device=X.device)
    q_prev = torch.zeros_like(q)
    ramp = torch.arange(n, dtype=dt, device=X.device)
    for i in range(ncv):
        Vi = V[:i]
        w = torch.mv(X, q)
        alpha = torch.dot(q, w)
        w = w - alpha * q - beta_prev * q_prev
        w = w - torch.mv(Vi.T, torch.mv(Vi, w))
        w = w - torch.mv(Vi.T, torch.mv(Vi, w))
        beta = torch.sqrt(torch.sum(w * w))
        # the restart vector on a breakdown, built every step as the scan
        # builds it (no host read)
        rcount = torch.tensor(i + 1, dtype=dt, device=X.device)
        fresh = torch.sin(ramp * (1.7 + 0.13 * rcount)) + 0.5
        fresh = (fresh - torch.mv(Vi.T, torch.mv(Vi, fresh))
                 - torch.dot(q, fresh) * q)
        fresh_n = torch.sqrt(torch.sum(fresh * fresh))
        fresh = fresh / torch.where(fresh_n > eps, fresh_n, 1.0)
        broke = beta <= 1e3 * tol
        q_next = torch.where(broke, fresh,
                             w / torch.where(beta > eps, beta, 1.0))
        beta_eff = torch.where(broke, 0.0, beta)
        V[i] = q
        alphas.append(alpha)
        betas.append(beta_eff)
        q_prev, q, beta_prev = q, q_next, beta_eff
    return torch.stack(alphas), torch.stack(betas), V


def lanczos_krylov(X, v0, ncv: int, tol: float):
    """(alphas (ncv,), betas (ncv,), V (ncv, n)) of ncv Lanczos steps on the
    symmetric (n, n) X from v0 (ops/lanczos.py:56-95): full
    reorthogonalisation twice per step, betas[i] = 0 and a deterministic
    restart vector on a breakdown (beta <= 1e3 * tol), V's rows the Lanczos
    vectors.  One cooperative launch on the card."""
    name = "lanczos_krylov"
    if X.dim() != 2 or X.shape[0] != X.shape[1]:
        raise ValueError(f"{name}: X must be square")
    n = X.shape[0]
    _check_vec(name, v0, n, "v0")
    if not 1 <= ncv <= n:
        raise ValueError(f"{name}: ncv = {ncv} outside [1, {n}]")
    if _on_cpu(name, X, v0):
        return lanczos_krylov_plain(X, v0, ncv, tol)
    nch = -(-n // LANCZOS_CHUNK)
    alphas = torch.empty(ncv, dtype=X.dtype, device=X.device)
    betas = torch.empty_like(alphas)
    V = torch.empty((ncv, n), dtype=X.dtype, device=X.device)
    ws = torch.empty(n + 3 * nch + (2 * ncv + 1) * nch, dtype=X.dtype,
                     device=X.device)
    _launch(name, X.dtype, X.device, _ptr(X), _ptr(v0), _ptr(V), _ptr(alphas),
            _ptr(betas), _ptr(ws), n, ncv, float(tol))
    return alphas, betas, V


# ------------------------------------------------ batched K1-K4 entry points
#
# The batch driver's forms of K1-K4 (parallel/batch.py): every vector has a
# leading instance axis B, the step scalars are (B,) tensors, b, h and c are
# per instance; the operator's tables are shared.  One launch per batch.


def _check_rows(name: str, t: torch.Tensor, B: int, n: int, what: str) -> None:
    if t.shape != (B, n):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"want ({B}, {n})")


def _value_stride(name: str, vals: torch.Tensor, table: tuple, B: int) -> int:
    """The per-instance value stride of an operator's values: 0 for one
    operator's ``table``-shaped values, the product of ``table`` for a
    (B, *table) stack of per-instance values."""
    if tuple(vals.shape) == table:
        return 0
    if tuple(vals.shape) == (B, *table):
        return math.prod(table)
    raise ValueError(f"{name}: operator values of shape {tuple(vals.shape)}, "
                     f"want {table} or {(B, *table)}")


def ell_spmv_batch_plain(idx, vals, V):
    return torch.sum(vals * V[:, idx], dim=-1)


def ell_spmv_batch(idx: torch.Tensor, vals: torch.Tensor, V: torch.Tensor):
    """out[b, r] = sum_j vals[r, j] * V[b, idx[r, j]] for a (B, ncols) V,
    the (nrows, width) values shared by every instance; or, for stacked
    (B, nrows, width) values, instance b's own vals[b, r, j] (K1b')."""
    name = "ell_spmv_batch"
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"{name}: want a 2-d int32 idx")
    if V.dim() != 2 or idx.shape[1] < 1:
        raise ValueError(f"{name}: bad V or table width")
    vstride = _value_stride(name, vals, tuple(idx.shape), V.shape[0])
    if _on_cpu(name, idx, vals, V):
        return ell_spmv_batch_plain(idx, vals, V)
    (nrows, width), (B, ncols) = idx.shape, V.shape
    out = torch.empty((B, nrows), dtype=V.dtype, device=V.device)
    _launch(name, V.dtype, V.device, _ptr(idx), _ptr(vals), _ptr(V), _ptr(out),
            B, nrows, width, ncols, vstride)
    if vstride:
        per_instance_launches[f"{name}_{_SUFFIX[V.dtype]}"] += 1
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


def linesearch_loop_batch_plain(M, y, Mx, Mx_old, b, h, y_old, Mty, Mty_old,
                                tau, tau_old, theta, beta, active, p: int,
                                m: int, delta: float, decay: float,
                                max_steps: int):
    ps = tau * torch.sqrt(1.0 + theta)
    sqrt_beta = torch.sqrt(beta)
    y_temp, Mty_t, theta_t = y, Mty, theta  # an inactive instance's values
    trials = torch.zeros(active.shape, dtype=torch.int32, device=y.device)
    done = ~active
    for _ in range(max_steps):
        th = ps / tau_old
        yt, dy = ls_dual_update_batch(y, Mx, Mx_old, b, h, y_old, beta * ps,
                                      th, p, m)
        mt = M.rmatvec_batch(yt)
        dM = sq_dist_batch(mt, Mty_old)
        ok = sqrt_beta * ps * torch.sqrt(dM) <= delta * torch.sqrt(dy)
        run = ~done  # an instance that accepted keeps that trial's values
        theta_t = torch.where(run, th, theta_t)
        y_temp = torch.where(run[:, None], yt, y_temp)
        Mty_t = torch.where(run[:, None], mt, Mty_t)
        ps = torch.where(run & ~ok, ps * decay, ps)
        trials = trials + run.to(torch.int32)
        done = done | ok
        if not bool(torch.any(~done)):  # one host read a trial
            break
    return y_temp, Mty_t, theta_t, torch.where(active, ps, tau), trials


def linesearch_loop_batch(M, y, Mx, Mx_old, b, h, y_old, Mty, Mty_old, tau,
                          tau_old, theta, beta, active, p: int, m: int,
                          delta: float, decay: float, max_steps: int):
    """``linesearch_loop`` for each instance of a batch (the vmapped
    while_loop, parallel/batch.py:141) over the batch's operator -- one
    ELL, COO or dense operator shared by every instance (the COO form's M'
    y is K14b's column segments), or one per instance (stacked ELL values
    or (B, p + m, n) matrices: K15b') -- rows (B, p + m) and (B, n),
    per-instance b, h and scalars (B,), and ``active`` (B,) bool.
    An active instance runs its own trials; an inactive one runs none and
    keeps its values (y, Mty, theta, tau).  Returns (y_temp, Mty, theta,
    ps, trials (B,) int32).  One launch on the card; on the CPU the plain
    loop, one host read a trial."""
    name = "linesearch_loop_batch"
    if y.dim() != 2 or Mty_old.dim() != 2:
        raise ValueError(f"{name}: y and Mty_old must be 2-d")
    B, rows = y.shape
    n = Mty_old.shape[1]
    if rows != p + m:
        raise ValueError(f"{name}: y has {rows} columns, want p + m = {p + m}")
    form, ptr, idx, vals, width = _rmatvec_form(name, M, rows, n)
    table = ((n, width) if form == LS_ELL else (idx.numel(),)
             if form == LS_COO else (rows, n))
    vstride = _value_stride(name, vals, table, B)
    for t, what in ((Mx, "Mx"), (Mx_old, "Mx_old"), (y_old, "y_old")):
        _check_rows(name, t, B, rows, what)
    _check_rows(name, b, B, p, "b")
    _check_rows(name, h, B, m, "h")
    _check_rows(name, Mty, B, n, "Mty")
    for t, what in ((tau, "tau"), (tau_old, "tau_old"), (theta, "theta"),
                    (beta, "beta"), (active, "active")):
        _check_vec(name, t, B, what)
    if active.dtype != torch.bool:
        raise TypeError(f"{name}: active must be bool")
    if max_steps < 1 or (rows < 1 and form == LS_ELL):
        raise ValueError(f"{name}: want max_steps >= 1 and an ELL operator "
                         f"with rows, got {max_steps} steps and {rows} rows")
    if _on_cpu(name, y, Mx, Mx_old, b, h, y_old, Mty, Mty_old, tau, tau_old,
               theta, beta, active, vals):
        return linesearch_loop_batch_plain(M, y, Mx, Mx_old, b, h, y_old, Mty,
                                           Mty_old, tau, tau_old, theta, beta,
                                           active, p, m, delta, decay,
                                           max_steps)
    dev, dt = y.device, y.dtype
    y_temp, Mty_out = torch.empty_like(y), torch.empty_like(Mty_old)
    theta_out, ps_out = torch.empty_like(theta), torch.empty_like(tau)
    trials = torch.empty(B, dtype=torch.int32, device=dev)
    _launch(name, dt, dev, *map(_ptr, (y, Mx, Mx_old, b, h, y_old, Mty,
                                       Mty_old, tau, tau_old, theta, beta,
                                       active)),
            None if ptr is None else _ptr(ptr),
            None if idx is None else _ptr(idx), _ptr(vals),
            *map(_ptr, (y_temp, Mty_out, theta_out, ps_out, trials)),
            B, p, m, n, width, vstride, form, int(max_steps), float(delta),
            float(decay))
    if vstride:
        per_instance_launches[f"{name}_{_SUFFIX[dt]}"] += 1
    return y_temp, Mty_out, theta_out, ps_out, trials


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


# ----------------------------- K16 batched GEMV (per-instance dense M)


def batched_gemv_plain(M, X):
    return torch.matmul(M, X.unsqueeze(-1)).squeeze(-1)


def batched_gemv_t_plain(M, Y):
    return torch.matmul(Y.unsqueeze(-2), M).squeeze(-2)


def _check_gemv(name: str, M: torch.Tensor, V: torch.Tensor, k: int) -> None:
    if M.dim() != 3:
        raise ValueError(f"{name}: M must be (B, R, n), got {tuple(M.shape)}")
    B, R, n = M.shape
    _check_rows(name, V, B, (R, n)[k], "the vector")


def batched_gemv(M: torch.Tensor, X: torch.Tensor):
    """out[b, r] = sum_j M[b, r, j] X[b, j]: each instance's (R, n) matrix
    times its own vector (the vmapped DenseOp.matvec of a
    ``dense_batched`` sweep), as (B, R)."""
    name = "batched_gemv"
    _check_gemv(name, M, X, 1)
    if _on_cpu(name, M, X):
        return batched_gemv_plain(M, X)
    B, R, n = M.shape
    out = torch.empty((B, R), dtype=X.dtype, device=X.device)
    _launch(name, X.dtype, X.device, _ptr(M), _ptr(X), _ptr(out), B, R, n)
    return out


def batched_gemv_t(M: torch.Tensor, Y: torch.Tensor):
    """out[b, j] = sum_r M[b, r, j] Y[b, r] (the vmapped DenseOp.rmatvec),
    as (B, n)."""
    name = "batched_gemv_t"
    _check_gemv(name, M, Y, 0)
    if _on_cpu(name, M, Y):
        return batched_gemv_t_plain(M, Y)
    B, R, n = M.shape
    out = torch.empty((B, n), dtype=Y.dtype, device=Y.device)
    _launch(name, Y.dtype, Y.device, _ptr(M), _ptr(Y), _ptr(out), B, R, n)
    return out


# ------------------------------------- K9 batched Jacobi PSD projection

# batched_eigh.cu (K9): A and V of one instance (2 n^2 words, n the side
# padded to even) in one block's 227 KB of shared memory.  Above these
# sides batched_eigh_large.cu (K9L) keeps them in device memory.
EIGH_MAX_SIDE = {torch.float64: 118, torch.float32: 168}


def _workspace(name: str, nbytes: int, dtype, device) -> torch.Tensor:
    """A kernel's scratch of ``nbytes`` (rounded up to its dtype) on
    ``device``; raises KernelError naming the kernel and the size where
    device memory cannot hold it."""
    size = torch.finfo(dtype).bits // 8 if dtype.is_floating_point else 1
    try:
        return torch.empty(-(-nbytes // size), dtype=dtype, device=device)
    except torch.OutOfMemoryError as e:
        raise KernelError(
            f"{name}: its working set of {nbytes} bytes does not fit in the "
            f"device memory of {device}") from e


def _eigh_rows(X):
    """torch.linalg.eigh of a (B, s, s) batch with jnp.linalg.eigh's NaN
    for an instance with a non-finite entry, that instance alone (torch
    raises there), and LAPACK's w = 0, V = I for an all-zero instance
    (cuSOLVER leaves its outputs unwritten there; ops.cones._eigh).  The
    tests are on the device: no host sync."""
    ok = torch.all(torch.isfinite(X), dim=(-2, -1))
    nz = torch.any((X != 0).flatten(1), dim=1)
    eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
    w, V = torch.linalg.eigh(torch.where((ok & nz)[:, None, None], X, eye))
    w = torch.where(nz[:, None], w, 0.0)
    V = torch.where(nz[:, None, None], V, eye)
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
    entry.  On the card K9 (the working set in one CTA's shared memory)
    to ``EIGH_MAX_SIDE`` (118 in f64, 168 in f32), K9L above: the same
    Jacobi in f64 (an f32 input too, its outputs rounded to f32), up to 16
    CTAs a matrix in cooperative launches, on a device-memory workspace of
    4 n^2 doubles an instance -- A, V and their second copies --, n the
    side rounded up to even."""
    name = "batched_psd_eigh"
    if X.dim() != 3 or X.shape[1] != X.shape[2]:
        raise ValueError(f"{name}: X must be (B, s, s)")
    if _on_cpu(name, X):
        return batched_psd_eigh_plain(X, tol_psd)
    B, s, _ = X.shape
    Xp = torch.empty_like(X)
    w = torch.empty((B, s), dtype=X.dtype, device=X.device)
    rank = torch.empty(B, dtype=torch.int32, device=X.device)
    warm = torch.empty((B, s), dtype=X.dtype, device=X.device)
    if s <= EIGH_MAX_SIDE[X.dtype]:
        _launch(name, X.dtype, X.device, _ptr(X), _ptr(Xp), _ptr(w),
                _ptr(rank), _ptr(warm), B, s, float(tol_psd))
        return Xp, w, rank, warm
    n = s + (s & 1)
    large = "batched_psd_eigh_large"
    ws = _workspace(large, B * 4 * n * n * 8, torch.float64, X.device)
    parts = torch.empty(B * 256, dtype=torch.float64, device=X.device)
    flags = torch.empty(B, dtype=torch.int32, device=X.device)
    _launch(large, X.dtype, X.device, _ptr(X), _ptr(Xp), _ptr(w), _ptr(rank),
            _ptr(warm), _ptr(ws), _ptr(parts), _ptr(flags), B, s,
            float(tol_psd))
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


# ------------------------------ K12 batched accept-always subspace step

SUBSPACE_MAX_K = 64  # K12's k; K12L takes k to SUBSPACE_LARGE_MAX_K
SUBSPACE_LARGE_MAX_K = 256  # the largest subspace bucket (solver._sub_bucket)
# batched_subspace.cu: one block's dynamic shared memory, less its static
# reduction buffer and flags
SUBSPACE_SMEM_BYTES = 232448 - 256 * 8 - 64


def subspace_smem_bytes(side: int, k: int, dtype, mixed: bool) -> int:
    """Shared memory of one batched_subspace.cu block (its smem_layout):
    the W and XW panels and theta, max(theta, 0) in the blocks' type; the
    Y/Q and Z panels, the k x k matrices and Jacobi's scratch in the basis
    type (f32 in the mixed mode); the sort permutation."""
    t = torch.finfo(dtype).bits // 8
    c = 4 if mixed else t
    n = k + (k & 1)
    return (2 * side * k * t + 2 * k * t + 2 * side * k * c + 2 * n * n * c
            + 2 * (n // 2) * c + n * c + n * 4)


def subspace_large_bytes(side: int, k: int, dtype, mixed: bool) -> tuple:
    """(bytes of one K12L instance's workspace, whether its k x k regions
    are in it): batched_subspace.cu's smem_layout split in two -- the
    panels (W, XW, theta, max(theta, 0) in the blocks' type, Y/Q and Z in
    the basis type) always in device memory, the k x k matrices, Jacobi's
    scratch and the permutation in shared memory where they fit; rounded
    up to 256 bytes."""
    t = torch.finfo(dtype).bits // 8
    c = 4 if mixed else t
    n = k + (k & 1)
    panels = 2 * side * k * t + 2 * k * t + 2 * side * k * c
    small = 2 * n * n * c + 2 * (n // 2) * c + n * c + n * 4
    small_global = small > SUBSPACE_SMEM_BYTES
    return -(-(panels + small * small_global) // 256) * 256, small_global


def _cholqr_batch_plain(Y, eps: float):
    """One CholeskyQR pass on each (side, k) panel of Y (B, side, k):
    ``cholqr_plain`` per instance, NaN for an instance whose
    Cholesky factor fails (jnp.linalg.cholesky's NaN)."""
    k = Y.shape[-1]
    G = torch.matmul(Y.transpose(-2, -1), Y)
    jit = eps * (torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / k + 1.0)
    L, info = torch.linalg.cholesky_ex(
        G + jit[:, None, None] * torch.eye(k, dtype=Y.dtype, device=Y.device))
    L = torch.where((info != 0)[:, None, None], torch.nan, L)
    return torch.linalg.solve_triangular(
        L, Y.transpose(-2, -1), upper=False).transpose(-2, -1)


def batched_subspace_plain(v_blocks, warm, side: int, tol_psd: float,
                           mixed: bool = False):
    """The accept-always subspace step of B instances (cones.py:427-510 under
    batch.py:141's vmap), kernel K12's plain version.

    ``v_blocks`` (B, tri_len) packed scaled triangles of X, ``warm`` (B,
    side, k) bases.  Q = cholqr2(X V), Z = X Q, (theta, U) = eigh(sym(Q^T
    Z)), W = Q U, XW = Z U; ``mixed`` (an f64 program's
    ``subspace_mixed``) builds Q, Z and U in f32 and takes XW = X W and
    theta = the Rayleigh quotients in f64.  Returns (blocks: W diag(max(
    theta, 0)) W^T packed, min_eig = min theta, rank = #theta > tol_psd
    (int32), warm = W with its columns reversed, bad, stats = [max_{theta>0}
    ||XW_j - theta_j W_j|| / max(max|theta|, 1), min theta, #theta > 0]),
    each with a leading instance axis.  ``bad`` is the NaN guard: where Xp
    has a non-finite entry, X (packed again) and the old basis go out.
    Where X V is exactly 0 the step orthonormalises V itself instead."""
    dtype = v_blocks.dtype
    bdt = torch.float32 if mixed else dtype
    eps = CHOLQR_EPS[bdt]
    X = tri_to_square_plain(v_blocks, side)
    Xb = X.to(bdt)
    Vb = warm.to(bdt)
    Y = torch.matmul(Xb, Vb)
    # X V exactly 0 (a cold start's first projection, X = 0): keep the old
    # basis, which the JAX step would turn into 0 for good (ROADMAP C11)
    Y = torch.where(torch.any(Y != 0, dim=(-2, -1))[:, None, None], Y, Vb)
    Q = _cholqr_batch_plain(_cholqr_batch_plain(Y, eps), eps)
    Zb = torch.matmul(Xb, Q)
    Bm = torch.matmul(Q.transpose(-2, -1), Zb)
    Bm = 0.5 * (Bm + Bm.transpose(-2, -1))
    if mixed:
        _, U = _eigh_rows(Bm)  # the f32 basis rotation
        W = torch.matmul(Q, U).to(dtype)
        XW = torch.matmul(X, W)
        theta = torch.sum(W * XW, dim=-2) / torch.sum(W * W, dim=-2)
    else:
        theta, U = _eigh_rows(Bm)  # ascending
        W = torch.matmul(Q, U)
        XW = torch.matmul(Zb, U)
    rn = torch.sqrt(torch.sum((XW - W * theta[:, None, :]) ** 2, dim=-2))
    pos = theta > 0.0
    scale = torch.clamp_min(torch.amax(torch.abs(theta), dim=-1), 1.0)
    tmin = torch.amin(theta, dim=-1)
    stats = torch.stack([torch.amax(torch.where(pos, rn, 0.0), dim=-1) / scale,
                         tmin, torch.sum(pos, dim=-1).to(dtype)], dim=-1)
    Xp = torch.matmul(W * torch.clamp_min(theta, 0.0)[:, None, :],
                      W.transpose(-2, -1))
    rank = torch.sum(theta > tol_psd, dim=-1).to(torch.int32)
    bad = ~torch.all(torch.isfinite(Xp).flatten(1), dim=1)
    Xp = torch.where(bad[:, None, None], X, Xp)
    wv = torch.where(bad[:, None, None], warm, W.flip(-1))
    return square_to_tri_plain(Xp, side), tmin, rank, wv, bad, stats


def batched_subspace(v, warm, side: int, tol_psd: float, mixed: bool = False):
    """One accept-always Rayleigh-Ritz step per instance
    (``batched_subspace_plain``): v (B, >= tri_len) packed scaled
    triangles (rows with unit column stride), warm (B, side, k) bases of
    v's dtype; ``mixed`` (f64 only) builds the basis in f32.  Returns
    (blocks (B, tri_len), min_eig (B,), rank (B,) int32, warm (B, side, k),
    bad (B,) bool, stats (B, 3)).  On the card K12 (one instance's working
    set in a block's shared memory, ``subspace_smem_bytes``) where that
    fits and k <= 64, else K12L (the same step, the same bits, its s x k
    panels in a device-memory workspace, ``subspace_large_bytes``) for k up
    to 256."""
    name = "batched_subspace"
    tl = side * (side + 1) // 2
    if v.dim() != 2 or v.shape[1] < tl or v.stride(1) != 1:
        raise ValueError(f"{name}: v must be (B, >= {tl}) with contiguous rows")
    B = v.shape[0]
    if warm.dim() != 3 or warm.shape[:2] != (B, side):
        raise ValueError(f"{name}: warm must be ({B}, {side}, k)")
    if mixed and v.dtype != torch.float64:
        raise TypeError(f"{name}: the mixed mode takes f64 blocks")
    if _on_cpu(name, warm, v[:, :tl], strided=True):
        return batched_subspace_plain(v[:, :tl], warm, side, tol_psd, mixed)
    if not warm.is_contiguous():
        raise ValueError(f"{name}: non-contiguous warm")
    k = warm.shape[2]
    if k > SUBSPACE_LARGE_MAX_K:
        raise ValueError(f"{name}: k = {k} > {SUBSPACE_LARGE_MAX_K}, the "
                         "largest subspace bucket")
    large = (k > SUBSPACE_MAX_K or subspace_smem_bytes(side, k, v.dtype, mixed)
             > SUBSPACE_SMEM_BYTES)
    dev, dt = v.device, v.dtype
    out = torch.empty((B, tl), dtype=dt, device=dev)
    me = torch.empty(B, dtype=dt, device=dev)
    rank = torch.empty(B, dtype=torch.int32, device=dev)
    warm_out = torch.empty_like(warm)
    bad = torch.empty(B, dtype=torch.bool, device=dev)
    stats = torch.empty((B, 3), dtype=dt, device=dev)
    eps = CHOLQR_EPS[torch.float32 if mixed else dt]
    head = (_ptr(v), v.stride(0) if B > 1 else v.shape[1], _ptr(warm),
            _ptr(out), _ptr(me), _ptr(rank), _ptr(warm_out), _ptr(bad),
            _ptr(stats))
    tail = (B, side, k, float(tol_psd), float(eps), float(1.0 / np.sqrt(2.0)),
            float(np.sqrt(2.0)))
    sfx = "f64_f32" if mixed else dt
    if not large:
        _launch(name, sfx, dev, *head, *tail)
    else:
        stride, _ = subspace_large_bytes(side, k, dt, mixed)
        ws = _workspace(name + "_large", B * stride, torch.uint8, dev)
        _launch(name + "_large", sfx, dev, *head, _ptr(ws), stride, *tail)
    return out, me, rank, warm_out, bad, stats


# K19-K21 (the control, the restart, the batch's freeze) live in their own
# module, which uses the helpers above
from .iteration_control import (  # noqa: E402
    ControlConfig, ControlStep, control, control_config, control_plain,
    control_step, freeze_rows,
    freeze_rows_plain, restart_adopt, restart_adopt_plain, restart_average,
    restart_average_plain)
