#!/usr/bin/env python3
"""Time the collectives of the port's sharded solves between two ranks
that share one CUDA card over gloo (chip_smoke.py's phase O setup).

    python3 tools/collective_costs.py

(on a machine with a CUDA card; about a minute).  Two processes
(``parallel.dist.spawn``, gloo, one card) time, over REPS calls each:
the all_gather of a side-250 block's row slab (125 x 250 f64, K18's and
K5's gather) and of a side-250 max-cut's M' y slab (31,250 f64, the
sharded operator's) with CUDA tensors handed to gloo, and the same with
the tensors copied to the host first and back after; a broadcast of one
host number (``Axis.agree``, rank 0's decisions); an all_reduce (a dense
operator's M x) and a broadcast of CUDA tensors, each checked once; then the f64 dense eigh
of a side-250 matrix (cuSOLVER) in both ranks at once against one rank
alone, which shows what the card's sharing costs.  Prints µs a call for
each, with the card's name and power limit, and exits non-zero where
there is no card.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

REPS = 200


def _timed(torch, fn, reps=REPS):
    import torch.distributed as dist

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def job(mesh):
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    out = {}
    for label, shape in (("block slab 125 x 250", (125, 250)),
                         ("M' y slab 31,250", (31250,))):
        x = torch.randn(shape, dtype=torch.float64, device=dev)
        bufs = [torch.empty_like(x) for _ in range(2)]
        hbufs = [torch.empty(shape, dtype=torch.float64) for _ in range(2)]

        def direct():
            dist.all_gather(bufs, x)
            return torch.cat(bufs)

        def staged():
            dist.all_gather(hbufs, x.cpu())
            return torch.cat(hbufs).to(dev)

        if not torch.equal(direct(), staged()):
            raise RuntimeError(f"{label}: the two gathers differ")
        out[f"all_gather {label}, CUDA tensors to gloo"] = _timed(torch, direct)
        out[f"all_gather {label}, staged on the host"] = _timed(torch, staged)
    h = torch.zeros(1, dtype=torch.float64)
    out["broadcast of one host number"] = _timed(
        torch, lambda: dist.broadcast(h, src=0))
    # the CUDA forms gloo also takes: a dense operator's M x sum
    # (all_reduce, 250 f64) and a broadcast on the card
    d = torch.full((250,), float(rank + 1), dtype=torch.float64, device=dev)
    dist.all_reduce(d)
    if not bool(torch.all(d == 3.0)):
        raise RuntimeError("all_reduce of a CUDA tensor gave a wrong sum")
    out["all_reduce of 250 f64, a CUDA tensor"] = _timed(
        torch, lambda: dist.all_reduce(d))
    c = torch.full((1,), float(rank), dtype=torch.float64, device=dev)
    dist.broadcast(c, src=0)
    if float(c[0]) != 0.0:
        raise RuntimeError("broadcast of a CUDA tensor gave rank 1's value")
    out["broadcast of one number, a CUDA tensor"] = _timed(
        torch, lambda: dist.broadcast(c, src=0))
    g = torch.randn((250, 250), dtype=torch.float64, device=dev)
    g = g + g.T
    out["f64 eigh side 250, both ranks at once"] = _timed(
        torch, lambda: torch.linalg.eigh(g), reps=50)
    for r in range(2):
        dist.barrier()
        if rank == r:
            out[f"f64 eigh side 250, rank {r} alone"] = _timed_alone(torch, g)
        dist.barrier()
    return out


def _timed_alone(torch, g, reps=50):
    for _ in range(3):
        torch.linalg.eigh(g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.linalg.eigh(g)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("collective_costs: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    from proxsdp_tpu_torch.parallel.dist import spawn

    outs = spawn(job, 2, device_type="cuda", backend="gloo", threads=0)
    print(smi)
    keys = list(dict.fromkeys(k for o in outs for k in o))
    for key in keys:
        vals = [f"rank {r} {o[key]:.1f}" for r, o in enumerate(outs) if key in o]
        print(f"{key}: {', '.join(vals)} us a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
