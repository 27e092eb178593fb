#!/usr/bin/env python3
"""Where a batch step's time goes: chip_smoke.py's phase-D profile on its
own, for one checkout of the port.

    python3 tools/profile_batch.py [--root DIR] [--batch 1024] [--side 16]

(on a machine with a CUDA card).  ``--root`` is the checkout whose
``proxsdp_tpu_torch`` and ``chip_smoke.py`` run (default: this one), so
two trees can be profiled in turns in one call, on one card.  For B
max-cut instances of the side (phase D's 1024 of side 16 by default), 16
steps of the f32 race program and 16 of the f64 program after 8 warm-up
steps each (``chip_smoke.profile_steps``): CUDA kernels a step, the
port's own launches a step, the device's busy share, ms a step.  Prints
the card's name and power limit first and one JSON object last; exits
non-zero where there is no card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--side", type=int, default=16)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("profile_batch: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)

    import chip_smoke
    from proxsdp_tpu_torch import Options, kernels
    from proxsdp_tpu_torch.models.maxcut import maxcut_problem, random_graph_weights
    from proxsdp_tpu_torch.problem import preprocess

    kernels.load()
    setups = [preprocess(maxcut_problem(random_graph_weights(s, args.side))[0])
              for s in range(args.batch)]
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": args.root, "batch": args.batch, "side": args.side}
    for label, dtype in (("f32", "float32"), ("f64", "float64")):
        per_step, ours, busy, ms, per_launch = chip_smoke.profile_steps(
            torch, kernels, setups, Options(dtype=dtype, hybrid_precision=False,
                                            tol_gap=1e-4, tol_feasibility=1e-4))
        out[label] = {"cuda_kernels_per_step": per_step,
                      "port_launches_per_step": ours, "device_busy": busy,
                      "ms_per_step": ms, "device_us_per_launch": per_launch}
        print(f"{label}: {ms:.3f} ms a step, CUDA kernels a step "
              f"{per_step}, the port's launches {ours:.2f}, device busy "
              f"{busy}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
