"""Carry state, operands and operator tables across as NumPy arrays.

The arrays are the JAX package's: ``state_from_numpy`` takes a dict keyed
by ``proxsdp_tpu.solver.State._fields`` (``warm`` a tuple), so the same
host arrays can seed a run of either package -- the parity tests start
both from one ``init_state``.  Dtypes are kept (f64 vectors and scalars,
i32 counters); scalars become 0-d tensors on the device.  A batch of
states (the JAX batch driver's, ``proxsdp_tpu.parallel.batch``) is the
same dict with axis 0 = instance on every array: ``stack_states`` and
``index_state`` build and split one, and the two functions below carry it
as they carry a single state.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.linop import DenseOp, linop_tables_to_ell

_DTYPES = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
}


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"unsupported state dtype {arr.dtype}")
    return torch.tensor(arr, dtype=_DTYPES[arr.dtype], device=device)


def state_from_numpy(fields: dict, device):
    """State on ``device`` from host arrays (a copy; ``fields`` is kept)."""
    from .solver import STATE_FIELDS, State

    kw = {}
    for name in STATE_FIELDS:
        v = fields[name]
        kw[name] = (tuple(_tensor(w, device) for w in v) if name == "warm"
                    else _tensor(v, device))
    return State(**kw)


def state_to_numpy(state) -> dict:
    """Host copy of every State field (``warm`` a tuple of arrays)."""
    from .solver import STATE_FIELDS

    out = {}
    for name in STATE_FIELDS:
        v = getattr(state, name)
        out[name] = (tuple(w.cpu().numpy() for w in v) if name == "warm"
                     else v.cpu().numpy())
    return out


def operands_from_numpy(*, M, b, h, c, norm_b, norm_h, norm_c, obj_scale,
                        device, dtype: torch.dtype = torch.float64):
    """Operands on ``device`` in ``dtype`` (f64 host values rounded once);
    ``M`` is a port operator (moved there, its values already in
    ``dtype``)."""
    from .solver import Operands

    def vec(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    return Operands(
        M=M.to(device), b=vec(b), h=vec(h), c=vec(c), norm_b=vec(norm_b),
        norm_h=vec(norm_h), norm_c=vec(norm_c), obj_scale=vec(obj_scale),
    )


def linop_from_tables(*, row_cols=None, row_vals=None, col_rows=None,
                      col_vals=None, mat=None, device,
                      dtype: torch.dtype = torch.float64):
    """The port's operator from a JAX ``EllOp``'s four tables or a
    ``DenseOp``'s matrix, given as NumPy arrays."""
    if mat is not None:
        return DenseOp(torch.tensor(np.asarray(mat), dtype=dtype, device=device))
    return linop_tables_to_ell(row_cols, row_vals, col_rows, col_vals,
                               dtype=dtype, device=device)


def stack_states(states) -> dict:
    """One batched state dict from per-instance dicts (axis 0 = instance;
    ``warm`` a tuple of (B, ...) arrays)."""
    out = {}
    for name, v in states[0].items():
        if name == "warm":
            out[name] = tuple(np.stack([st[name][j] for st in states])
                              for j in range(len(v)))
        else:
            out[name] = np.stack([np.asarray(st[name]) for st in states])
    return out


def index_state(states: dict, i: int) -> dict:
    """Instance ``i`` of a batched state dict of host arrays."""
    return {name: (tuple(np.asarray(w)[i] for w in v) if name == "warm"
                   else np.asarray(v)[i])
            for name, v in states.items()}
