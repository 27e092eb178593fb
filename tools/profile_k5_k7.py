#!/usr/bin/env python3
"""Device time of K5 (``ns_gemm``, ``ns_gemm_batch``) and K7 (``cholqr``)
under torch.profiler, by CUDA function, at the shapes of the port's paths.

    python3 tools/profile_k5_k7.py

(on a machine with a CUDA card; ~1 minute with the build).  For each shape
-- K5's polar product at sides 250 and 2000, the k = 128 reseed slices,
K5b at side 250, B = 16; K7 at side 250, k = 24 and 16 (its single-CTA
small pass) and side 2000, k = 32, 128, 192, 256 (G, the factor and the
solve) -- the device µs a call of every CUDA function the call launched,
over 20 calls after 3 warm-up calls.  Prints the card's name and power
limit first and one JSON object last; exits non-zero where there is no
card.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_k5_k7: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    from proxsdp_tpu_torch import kernels

    kernels.load()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    calls = 20

    def mat(*shape, dt):
        return torch.tensor(rng.standard_normal(shape), dtype=dt, device=dev)

    def device_us(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_fn = {}
        for e in prof.key_averages():
            name = re.search(r"(gemm_axpby|cholqr_\w+?)_kernel", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and name:
                by_fn[name.group(1)] = round(
                    by_fn.get(name.group(1), 0.0)
                    + e.self_device_time_total / calls, 2)
        return by_fn

    rows = []
    for dt in (torch.float32, torch.float64):
        cases = []
        for side in (250, 2000):
            A = mat(side, side, dt=dt) / side
            cases.append((f"ns_gemm side {side}",
                          lambda A=A: kernels.ns_gemm(A, A, A, 0.5, 1.5)))
        S, W = mat(2000, 2000, dt=dt), mat(2000, 128, dt=dt)
        cases += [
            ("ns_gemm P+ slice k=128",
             lambda: kernels.ns_gemm(S, W[:, :-1], W[:, :-1], 0.5, 0.5)),
            ("ns_gemm P- slice k=128",
             lambda: kernels.ns_gemm(S, W[:, -1:], W[:, -1:], 0.5, -0.5))]
        X = mat(16, 250, 250, dt=dt) / 250
        cases.append(("ns_gemm_batch B=16 side 250",
                      lambda: kernels.ns_gemm_batch(X, X, X, 0.5, 1.5)))
        Xs = mat(2000, 2000, dt=dt)
        for side, k in ((250, 24), (250, 16), (2000, 32), (2000, 128),
                        (2000, 192), (2000, 256)):
            Y = Xs[:side, :side] @ mat(side, k, dt=dt)
            cases.append((f"cholqr side {side} k={k}",
                          lambda Y=Y: kernels.cholqr(Y)))
        for label, fn in cases:
            by_fn = device_us(fn)
            total = round(sum(by_fn.values()), 2)
            print(f"{label} {dt}: device {total} us a call {by_fn}",
                  flush=True)
            rows.append({"case": label, "dtype": str(dt), "device_us": total,
                         "by_function": by_fn})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
