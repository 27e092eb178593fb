"""Readings behind chip_smoke.py's phase-L bounds, on a CUDA card.

    python3 tools/phase_l_diagnostics.py rows [SEED ...]

runs phase L's phase-B rows (K9L, K12L, K5b, K6b against their plain
versions) once for each input seed (default 12, chip_smoke's, and 13) and
prints every reading; a reading above its bound is printed, not fatal.

    python3 tools/phase_l_diagnostics.py l2-scatter

solves phase L2's 40 side-500 max-cut instances twice, with the subspace
step's plain version (cuBLAS and cuSOLVER) and with its kernels (K12,
K12L), and prints each against the JAX reference run and the two against
each other, with a certified interval [lower, upper] around each
instance's optimum from the kernels' answer.

Neither gates anything: chip_smoke.py holds the bounds.
"""

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def maxcut_bounds(res, W, Xidx):
    """A certified interval [lower, upper] around a max-cut relaxation's
    optimum (max <W/4, X>, diag X = 1, X psd) from a solve's answer: the
    lower bound from its X made feasible (negative eigenvalues cut, then
    scaled to a unit diagonal), the upper bound from its dual y (for any
    y: sum(y) + n max(0, lambda_max(C - Diag(y))), the sign of y taken
    that gives the smaller)."""
    C = 0.25 * W
    n = W.shape[0]
    w, V = np.linalg.eigh(res.primal[Xidx])
    Xp = (V * np.maximum(w, 0.0)) @ V.T
    d = np.sqrt(np.maximum(np.diag(Xp), 1e-300))
    lower = float(np.sum(C * (Xp / np.outer(d, d))))
    y = np.asarray(res.dual_eq, np.float64)
    upper = min(float(np.sum(sy)) + n * max(0.0, float(np.linalg.eigvalsh(
        C - np.diag(sy))[-1])) for sy in (y, -y))
    return lower, upper


def rows(torch, kernels, seeds):
    failed = []

    def check(cond, msg):
        if not cond:  # printed before the row it belongs to
            print(f"above its bound: {msg}")
            failed.append(msg)

    cs.check = check
    for seed in seeds:
        print(f"---- phase L rows, input seed {seed}")
        cs.large_kernel_checks(torch, kernels, np.random.default_rng(seed),
                               torch.device("cuda"))
    print(f"{len(failed)} readings above their bounds")


def l2_scatter(torch, kernels, smi):
    from proxsdp_tpu_torch import Options
    from proxsdp_tpu_torch.models.maxcut import random_graph_weights

    base = Options(tol_gap=1e-4, tol_feasibility=1e-4)
    l2 = cs._l_maxcut(cs.L2_SIDE, cs.L2_SIZE)
    probs, Xidx = [p for p, _ in l2], l2[0][1]
    ref = np.array(cs.L2_REF_OBJ)
    kernel_fn = kernels.batched_subspace

    def plain(v, warm, side, tol_psd, mixed=False):
        tl = side * (side + 1) // 2
        return kernels.batched_subspace_plain(v[:, :tl], warm, side, tol_psd,
                                              mixed)

    objs = {}
    for label, fn in (("plain", plain), ("kernels", kernel_fn)):
        kernels.batched_subspace = fn
        try:
            res, _, _, stats = cs._l_run(torch, kernels, f"L2 ({label})", smi,
                                         probs, base)
        finally:
            kernels.batched_subspace = kernel_fn
        objs[label] = np.array([r.objval for r in res])
        dev = np.abs(objs[label] - ref) / (1 + np.abs(ref))
        print(f"L2 ({label}) vs the JAX run: max |diff|/(1+|ref|) "
              f"{dev.max():.3e}, mean {dev.mean():.3e}; reseeds "
              f"{stats.reseeds}")
    d = np.abs(objs["plain"] - objs["kernels"]) / (1 + np.abs(objs["kernels"]))
    print(f"L2 plain vs kernels: max |diff|/(1+|obj|) {d.max():.3e}, "
          f"mean {d.mean():.3e}")
    iv = np.array([maxcut_bounds(r, random_graph_weights(i, cs.L2_SIDE), Xidx)
                   for i, r in enumerate(res)])
    obj = objs["kernels"]
    scale = 1.0 + np.abs(iv[:, 1])
    print(f"L2 certified intervals [lower, upper] from the kernels' X and y, "
          f"relative to 1 + |upper|: width max "
          f"{((iv[:, 1] - iv[:, 0]) / scale).max():.3e}, median "
          f"{np.median((iv[:, 1] - iv[:, 0]) / scale):.3e}; the objective "
          f"above the upper bound by at most "
          f"{((obj - iv[:, 1]) / scale).max():.3e}; the JAX run's objectives "
          f"below the lower bound by at most "
          f"{((iv[:, 0] - ref) / scale).max():.3e}")


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from proxsdp_tpu_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kernels.load()
    cs.SHAPES = cs.ShapeCounts(kernels)
    cs.TRIALS = cs.TrialCounts(torch, kernels)
    if sys.argv[1] == "rows":
        rows(torch, kernels, [int(a) for a in sys.argv[2:]] or [12, 13])
    elif sys.argv[1] == "l2-scatter":
        l2_scatter(torch, kernels, smi)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
