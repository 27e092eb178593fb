"""Tensor-parallel solve: one large PSD block's work split over ranks
(``proxsdp_tpu/parallel/sharded.py``).

The JAX package row-shards the dense block over a mesh axis with one
sharding constraint (cones.py:177-191), shards the operator
(``linop.shard_linop``) and lets GSPMD insert the collectives.  The port
runs one process a rank (``parallel.dist``) with the same names:
``solve_sharded`` sets a context-local mesh that ``current_tp_mesh()``
returns, and sets ``tp_shards`` to the axis size; ``tp_shards > 0`` with
no active mesh is a plain solve.  The design is replicated iterate, split
work: every rank holds the whole iterate and the scalar state, and only
the work the JAX layout shards is split --

* the operator (``ops.linop.shard_linop``): an ELL operator's row and
  column tables by rows, each product K1 on the rank's slice and one
  all_gather (every entry as the unsharded product computes it); a dense
  one by columns, M x a partial product and an all_reduce, M' y the
  rank's columns and an all_gather; COO unchanged;
* the PSD projection (``ops.cones``): rank r owns rows ``span(side)`` of
  each dense block's result -- the dense eigh runs replicated (GSPMD has
  no sharded eigh either), then K18 reconstructs the rank's rows and an
  all_gather assembles the block; each Newton-Schulz product of the polar
  projection runs on the rank's row slab of K5, then an all_gather; the
  subspace, sign, accept-always and Lanczos steps run replicated;
* the linesearch: K15 reads the whole M' and cannot span ranks, so the
  trials run the sequence K15 is held to -- K2, the sharded M' y, K2's
  sq_dist, one host read a trial.

Every host decision is rank 0's, broadcast (the ``solver`` and ``cones``
reads go through ``current_tp(opts)``'s ``flag``, ``values`` and ``obj``;
the clock is rank 0's ``Axis.now``), and at the end of a solve the ranks'
checksums of x and y at every chunk end must agree, or the solve raises
``RuntimeError`` naming the first iteration where they differ.  Only
rank 0 prints or writes a checkpoint; ``resume_from`` is read by every
rank.

Usage, one call per rank (``parallel.dist.spawn`` starts them)::

    mesh = DeviceMesh("cuda", [0, 1], mesh_dim_names=("tp",))
    res = solve_sharded(problem, mesh)
"""

from __future__ import annotations

import contextlib
import contextvars

from ..options import Options
from ..result import Result
from .dist import LOCAL, Axis, Local, mesh_device

# the active tensor-parallel Axis (its mesh and axis name), or None
_TP: contextvars.ContextVar = contextvars.ContextVar("proxsdp_tp",
                                                     default=None)


def current_tp_mesh():
    """(mesh, axis_name) if a tensor-parallel solve is active, else None."""
    axis = _TP.get()
    return None if axis is None else (axis.mesh, axis.name)


def current_tp(opts) -> Axis | Local:
    """The active tensor-parallel axis of a solve under ``opts``, or
    ``LOCAL`` unless ``opts.tp_shards > 0`` and a mesh is active: the one
    place a solve's host decisions come from (``flag``, ``values``,
    ``obj``; the axis's ``now`` is its clock), and ``sharded`` says
    whether its work is split."""
    axis = _TP.get() if opts.tp_shards > 0 else None
    return LOCAL if axis is None else axis


@contextlib.contextmanager
def tp_context(mesh, tp_axis: str = "tp"):
    """Make ``mesh[tp_axis]`` the active tensor-parallel axis (the
    ``Axis`` every solve under it shares, its collectives counted) and
    yield that ``Axis``; inside an active context of the same mesh and
    axis, its ``Axis`` again."""
    axis = _TP.get()
    if axis is None or axis.mesh is not mesh or axis.name != tp_axis:
        axis = Axis(mesh, tp_axis)
    token = _TP.set(axis)
    try:
        yield axis
    finally:
        _TP.reset(token)


def solve_sharded(problem, mesh, options: Options | None = None,
                  tp_axis: str = "tp", resume_from=None, **kwargs) -> Result:
    """Solve with the PSD-block work split over ``mesh[tp_axis]``; every
    rank of the axis calls this with the same arguments and gets the same
    Result.  Each rank computes on its mesh's device: the CPU on a "cpu"
    mesh, else the card the process selected (``parallel.dist.spawn``
    selects one a rank), and a "cuda" mesh without a card raises."""
    from ..solver import solve

    opts = (options or Options()).replace(**kwargs)
    names = tuple(mesh.mesh_dim_names or ())
    if tp_axis not in names:
        raise ValueError(f"mesh has no axis {tp_axis!r}: {names}")
    opts = opts.replace(tp_shards=int(mesh.size(names.index(tp_axis))))
    with tp_context(mesh, tp_axis):
        return solve(problem, opts, resume_from=resume_from,
                     device=mesh_device(mesh))
