"""Ranks and collectives of the port's multi-process solves.

The JAX package lays its arrays over a ``jax.sharding.Mesh`` and lets
GSPMD insert the collectives (``proxsdp_tpu/parallel/sharded.py``,
``batch.py:291-297``).  The port runs SPMD instead: one process a rank,
every rank calls the same entry point with the same arguments, and a
``torch.distributed.device_mesh.DeviceMesh`` names the axes
(``solve_batch(mesh=..., batch_axis=...)``, ``solve_sharded(problem,
mesh, tp_axis=...)``).  ``Axis`` is one named axis of such a mesh: its
process group, its size and this rank's place in it, and the few
collectives the solvers call -- the rows of a split tensor gathered, a
sum, rank 0's host values broadcast (so that every rank takes rank 0's
decisions and reads rank 0's clock), Python objects gathered.  The
collectives go to whatever backend the mesh's group has: NCCL on a
machine with a card a rank, gloo on the CPU or where several ranks share
one card (NCCL refuses two ranks on one device).  Gloo takes CUDA tensors
in ``all_reduce``, ``broadcast`` and the list form of ``all_gather``,
staged through the host; host values travel as CPU tensors under gloo and
as tensors on the rank's card under NCCL.

``spawn`` starts the ranks of one job (``torch.multiprocessing``, the
"spawn" start method), joins them over ``tcp://localhost``, builds the
mesh and returns every rank's return value.
"""

from __future__ import annotations

import math
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist


def split(n: int, parts: int) -> list:
    """[(lo, hi)] of ``parts`` contiguous shares of n rows, ceil(n / parts)
    rows each but the last ones (a share may be empty)."""
    chunk = -(-n // parts)
    return [(min(r * chunk, n), min((r + 1) * chunk, n)) for r in range(parts)]


class RankDivergence(RuntimeError):
    """The ranks of a replicated computation hold different values."""


class Axis:
    """One named axis of a ``DeviceMesh``: ``group``, ``size``, ``rank``
    (this process's index on the axis) and the solvers' collectives.
    ``collectives`` counts the collective calls made through it.  The host
    decisions of a solve on the axis are rank 0's: ``flag``, ``values``,
    ``obj`` and the clock ``now`` (``Local`` is the same interface on one
    process, whose clock is its own)."""

    sharded = True

    def __init__(self, mesh, name: str):
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if name not in names:
            raise ValueError(f"mesh has no axis {name!r}: {names}")
        self.mesh, self.name = mesh, name
        self.group = mesh.get_group(name)
        self.size = int(mesh.size(names.index(name)))
        self.rank = int(mesh.get_local_rank(name))
        self.backend = str(dist.get_backend(self.group))
        self.src = dist.get_global_rank(self.group, 0)
        self.collectives = 0

    def span(self, n: int) -> tuple:
        """This rank's rows [lo, hi) of n (``split``)."""
        return split(n, self.size)[self.rank]

    def host_device(self) -> torch.device:
        """Where host values travel: the CPU under gloo, the rank's card
        under NCCL."""
        if self.backend == "gloo":
            return torch.device("cpu")
        return torch.device("cuda", torch.cuda.current_device())

    def all_gather_rows(self, part: torch.Tensor, n: int) -> torch.Tensor:
        """The (n, ...) tensor whose rows ``span(n)`` each rank holds as
        ``part``: one all_gather of shares padded to ceil(n / size) rows."""
        spans = split(n, self.size)
        chunk = spans[0][1] - spans[0][0]
        if part.shape[0] != chunk:
            part = torch.cat([part, part.new_zeros((chunk - part.shape[0],)
                                                   + tuple(part.shape[1:]))])
        part = part.contiguous()
        bufs = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(bufs, part, group=self.group)
        self.collectives += 1
        return torch.cat([b[: hi - lo] for b, (lo, hi) in zip(bufs, spans)])

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """t reduced over the axis, in place (and returned)."""
        dist.all_reduce(t, op=op, group=self.group)
        self.collectives += 1
        return t

    def values(self, values) -> list:
        """Rank 0's host numbers (a flat sequence of ints and floats, as
        f64 values): one broadcast."""
        vals = [float(v) for v in values]
        t = torch.tensor(vals, dtype=torch.float64, device=self.host_device())
        dist.broadcast(t, src=self.src, group=self.group)
        self.collectives += 1
        return t.cpu().tolist()

    def flag(self, flag) -> bool:
        """Rank 0's host bool of a 0-d device flag (read here)."""
        return bool(self.values([bool(flag)])[0])

    def obj(self, obj):
        """Rank 0's Python object: one broadcast_object_list."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        self.collectives += 1
        return box[0]

    def now(self) -> float:
        """Rank 0's ``time.time()``: every clock decision of a solve reads
        this one clock, so the ranks leave at the same chunk."""
        return self.values([time.time()])[0]

    def max(self, value: float) -> float:
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.host_device())
        return float(self.all_reduce(t, dist.ReduceOp.MAX).cpu()[0])

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        self.collectives += 1
        return out

    def check_agreement(self, checks, what: str) -> None:
        """Raise RankDivergence unless every rank holds the same values in
        ``checks`` [(iteration, [values...])]: one all_reduce of MAX and
        one of MIN over all of them (NaN compared as NaN)."""
        if not checks:
            return
        sentinel = 1.2345678e300
        rows = [[sentinel if math.isnan(v) else v for v in vals]
                for _, vals in checks]
        hi = torch.tensor(rows, dtype=torch.float64, device=self.host_device())
        lo = hi.clone()
        self.all_reduce(hi, dist.ReduceOp.MAX)
        self.all_reduce(lo, dist.ReduceOp.MIN)
        bad = torch.nonzero(torch.any(hi != lo, dim=1)).flatten().tolist()
        if bad:
            k = checks[bad[0]][0]
            raise RankDivergence(
                f"the {self.size} ranks of mesh axis {self.name!r} diverged: "
                f"{what} differ first at iteration {k} (checked at "
                f"{len(checks)} chunk ends, {len(bad)} of them differ)")


class Local:
    """The stand-in for an ``Axis`` off tensor parallelism: one process,
    whose host decisions and clock are its own."""

    sharded = False
    rank = 0

    @staticmethod
    def flag(flag) -> bool:
        return bool(flag)

    @staticmethod
    def values(values) -> list:
        return list(values)

    @staticmethod
    def obj(obj):
        return obj


LOCAL = Local()


def mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` computes on: the CPU for a "cpu" mesh,
    else the card the process has selected (``spawn`` selects card rank %
    device_count)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"a {mesh.device_type!r} mesh, but no CUDA card is "
                           "available (torch.cuda.is_available() is false)")
    return torch.device("cuda", torch.cuda.current_device())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device_type, axis, threads, fn,
               args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        if device_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"rank {rank}: no CUDA card is available")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh(device_type, list(range(world)),
                          mesh_dim_names=(axis,))
        out.put((rank, True, fn(mesh, *args)))
    except Exception:  # noqa: BLE001 -- reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str = "gloo",
          device_type: str = "cuda", axis: str = "tp", threads: int = 1,
          timeout: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` in ``nprocs`` new processes joined into one
    process group (``backend``, over tcp://localhost) with a 1-d
    ``DeviceMesh`` of ``device_type`` over them whose axis is named
    ``axis``; return the ranks' return values in rank order.  ``fn`` and
    ``args`` must pickle (``fn`` a module-level function).  On a "cuda"
    mesh (the default) rank r computes on card r % device_count, and a
    rank that finds no card raises; pass ``device_type="cpu"`` for CPU
    ranks.  ``threads`` sets each rank's torch threads (0: torch's
    default).  A rank that raises, dies or outlives
    ``timeout`` seconds ends the job: every process is stopped and a
    RuntimeError carries the first failure."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        rank, nprocs, port, backend, device_type, axis, threads, fn, args,
        results)) for rank in range(nprocs)]
    for p in procs:
        p.start()
    outs, error = {}, None
    deadline = time.time() + timeout
    try:
        while len(outs) < nprocs and error is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in outs and p.exitcode not in (None, 0)]
                if dead:
                    error = (f"rank {dead[0]} exited with code "
                             f"{procs[dead[0]].exitcode}")
                elif time.time() > deadline:
                    error = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                outs[rank] = val
            else:
                error = f"rank {rank} failed:\n{val}"
    finally:
        for p in procs:
            p.join(timeout=0 if error else 30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if error:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}): {error}")
    return [outs[r] for r in range(nprocs)]
