#!/usr/bin/env python3
"""Where the time of the port's default solve goes, on one CUDA card.

    python3 profile_torch.py [--side 250] [--hybrid-precision 0|1]

Solves maxcut_problem(random_graph_weights(0, side)) with the default
Options() (or hybrid_precision=False) through proxsdp_tpu_torch on the
card, three times after a warm-up:

1. with every chunk of every program timed (a synchronize on each side):
   wall time and iterations/s of the f32 polar race, the f32 subspace
   race and the f64 polish (the programs of the hybrid driver);
2. with nothing added: the wall time the device-busy share is taken
   against;
3. under torch.profiler (CPU and CUDA activities): device time by kernel
   group and launches per iteration.

Prints one JSON object as its last line.  Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

# kernel name pattern -> group (first match wins)
GROUPS = (
    ("K5 ns_gemm", r"gemm_axpby"),
    ("K6 polar_sym", r"sumsq_kernel|scale_kernel|sym_kernel|sym_flag|guard_kernel"),
    ("K7 cholqr", r"cholqr"),
    ("K8 ritz_accept", r"ritz_accept"),
    ("K1 ell_spmv", r"ell_spmv"),
    ("K2 ls_dual_update/sq_dist", r"ls_dual_update|sq_dist"),
    ("K3 residuals", r"residuals"),
    ("K2/K3 second pass", r"finalize_kernel"),
    ("K4 primal_update_sym", r"sym_tile|update_tail"),
    ("eigh (cuSOLVER)", r"syevd|syevj|sytrd|orgtr|ormtr|steqr|stedc|laed|larf|"
                        r"lacpy|cusolver|potrf|geqrf|trsm|syhemv|sytd2"),
    ("GEMM (cuBLAS)", r"gemm|Kernel2|cutlass|xmma|sm90"),
)


def _group(name: str) -> str:
    for group, pat in GROUPS:
        if re.search(pat, name, re.I):
            return group
    return "other (torch elementwise, copies)"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=250)
    ap.add_argument("--hybrid-precision", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    from proxsdp_tpu_torch import Options, kernels
    from proxsdp_tpu_torch import solver as tsolver
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights

    kernels.load()
    problem, _ = maxcut_problem(random_graph_weights(0, args.side))
    opts = Options(hybrid_precision=bool(args.hybrid_precision))
    tsolver.solve(problem, opts)  # warm-up
    torch.cuda.synchronize()

    # 1. every chunk timed, labelled by its program
    chunks = []
    make = tsolver.make_chunk_runner

    def timed_runner(layout, po, *, device):
        run, it, fetch = make(layout, po, device=device)
        label = (f"{po.dtype} "
                 + (f"subspace k={po.subspace_rank}" if po.subspace_rank
                    else f"{po.projection} projection"))

        def run_timed(s, o, chunk_end):
            k0 = int(s.iter)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = run(s, o, chunk_end)
            torch.cuda.synchronize()
            chunks.append((label, k0, int(s.iter), time.perf_counter() - t0))
            return s

        return run_timed, it, fetch

    tsolver.make_chunk_runner = timed_runner
    try:
        res = tsolver.solve(problem, opts)
    finally:
        tsolver.make_chunk_runner = make
    programs: dict = {}
    for label, k0, k1, dt in chunks:
        p = programs.setdefault(label, {"iterations": 0, "seconds": 0.0,
                                        "chunks": []})
        p["iterations"] += k1 - k0
        p["seconds"] += dt
        p["chunks"].append([k0, k1, dt])
    for label, p in programs.items():
        p["ms_per_iteration"] = 1e3 * p["seconds"] / max(p["iterations"], 1)
        print(f"{label:28s} {p['iterations']:5d} iterations {p['seconds']:.3f} s "
              f"{p['ms_per_iteration']:.3f} ms/iteration")

    # 2. the plain wall time
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tsolver.solve(problem, opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    print(f"solve: status {res.status} iterations {res.iter} objval "
          f"{res.objval!r} wall {wall:.3f} s ({res.iter / wall:.1f} it/s)")

    # 3. the profiled solve: device time by kernel group
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res_p = tsolver.solve(problem, opts)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    groups: dict = {}
    launches = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        g = groups.setdefault(_group(evt.key), {"ms": 0.0, "launches": 0})
        g["ms"] += us / 1e3
        g["launches"] += evt.count
        launches += evt.count
    device_ms = sum(g["ms"] for g in groups.values())
    if device_ms == 0:
        print("profile_torch: the profiler recorded no device time")
    for name, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
        g["share"] = g["ms"] / max(device_ms, 1e-12)
        print(f"{name:34s} {g['ms']:9.2f} ms {100 * g['share']:5.1f} % "
              f"{g['launches']:7d} launches")
    busy = device_ms / 1e3 / wall
    print(f"device time {device_ms:.2f} ms over {res_p.iter} iterations "
          f"({device_ms / res_p.iter:.3f} ms/iteration); unprofiled wall "
          f"{wall:.3f} s -> device busy {busy:.3f}, idle {1 - busy:.3f}; "
          f"{launches / res_p.iter:.1f} device kernels per iteration")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "side": args.side, "hybrid_precision": bool(args.hybrid_precision),
        "iterations": res.iter, "wall_s": wall, "programs": programs,
        "device_ms": device_ms, "device_idle_share": 1 - busy,
        "kernels_per_iteration": launches / res_p.iter, "groups": groups,
        "entry_launches": counts,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
