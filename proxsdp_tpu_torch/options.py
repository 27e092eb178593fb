"""Solver options: the same frozen dataclass as ``proxsdp_tpu/options.py``.

Every field and default is identical to the JAX package's, so one
``Options`` value means the same thing in both packages (a test compares
the two field by field).  The field comments of the JAX package explain
each knob; here they only say which ones the port honours.  The port
honours every field but ``tp_shards``, for which ``solver.solve`` and
``solve_batch`` raise ``NotImplementedError`` (naming ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Options:
    # printing (reference src/options.jl:3-16); extended_log2's
    # dual-feasibility column is not computed by the port
    log_verbose: bool = False
    log_freq: int = 1000
    timer_verbose: bool = False
    timer_file: bool = False
    disable_julia_logger: bool = True
    time_limit: float = 360000.0
    warn_on_limit: bool = False
    extended_log: bool = False
    extended_log2: bool = False
    log_repeat_header: bool = False

    # tolerances (reference src/options.jl:18-28)
    tol_gap: float = 1e-4
    tol_feasibility: float = 1e-4
    tol_feasibility_dual: float = 1e-4
    tol_primal: float = 1e-4
    tol_dual: float = 1e-4
    tol_psd: float = 1e-7
    tol_soc: float = 1e-7
    check_dual_feas: bool = False
    check_dual_feas_freq: int = 1000
    max_obj: float = 1e20
    min_iter_max_obj: int = 10

    # infeasibility heuristics (reference src/options.jl:33-39)
    min_iter_time_infeas: int = 1000
    infeas_gap_tol: float = 1e-4
    infeas_limit_gap_tol: float = 1e-1
    infeas_stable_gap_tol: float = 1e-4
    infeas_feasibility_tol: float = 1e-4
    infeas_stable_feasibility_tol: float = 1e-8
    certificate_search: bool = True
    certificate_obj_tol: float = 1e-1
    certificate_fail_tol: float = 1e-8

    min_beta: float = 1e-5
    max_beta: float = 1e5
    initial_beta: float = 1.0

    # step balance: "reference" (pdhg.jl:306-332) or "ratio"
    step_balance: str = "ratio"
    step_balance_ratio: float = 10.0
    initial_adapt_level: float = 0.9
    adapt_decay: float = 0.8
    adapt_window: int = 50

    # PDHG (reference src/options.jl:55-63)
    convergence_window: int = 200
    convergence_check: int = 50
    max_iter: int = 0
    min_iter: int = 40
    divergence_min_update: int = 50
    max_iter_lp: int = 10_000_000
    max_iter_conic: int = 1_000_000
    advanced_initialization: bool = True

    # Malitsky-Pock linesearch (reference src/options.jl:67-72)
    line_search_flag: bool = True
    max_linsearch_steps: int = 5000
    delta: float = 0.9999
    initial_theta: float = 1.0
    linsearch_decay: float = 0.75

    # spectral decomposition (reference src/options.jl:74-89)
    full_eig_decomp: bool = False
    max_target_rank_krylov_eigs: int = 16
    min_size_krylov_eigs: int = 100
    warm_start_eig: bool = True
    rank_increment: int = 1
    rank_increment_factor: int = 1
    eigsolver: int = 2
    eigsolver_min_lanczos: int = 25
    eigsolver_resid_seed: int = 1234
    arpack_tol: float = 1e-10
    arpack_resid_init: int = 3
    arpack_reset_resid: bool = True
    arpack_max_iter: int = 10_000
    krylovkit_reset_resid: bool = False
    krylovkit_resid_init: int = 3
    krylovkit_tol: float = 1e-12
    krylovkit_max_iter: int = 100
    krylovkit_eager: bool = False
    krylovkit_verbose: int = 0
    reduce_rank: bool = False
    rank_slack: int = 3
    full_eig_freq: int = 10_000_000
    full_eig_len: int = 0

    # data normalisation (SetupProblem.obj_scale / rhs_scale)
    scale_objective: bool = True
    scale_rhs: bool = True

    # equilibration (reference src/options.jl:122-128) and the block
    # Ruiz variant with its "auto" probe; ROADMAP A6 in the port
    equilibration: bool = False
    equilibration_iters: int = 1000
    equilibration_lb: float = -10.0
    equilibration_ub: float = +10.0
    equilibration_limit: float = 0.9
    equilibration_force: bool = False
    block_equilibration: object = "auto"
    block_equilibration_iters: int = 10
    block_equilibration_spread: float = 1e3
    block_equilibration_probe_spread: float = 3.0
    block_equilibration_probe_iters: int = 6000
    block_equilibration_probe_margin: float = 1.3

    # True: Frobenius bound for ||M||; False: host power iteration
    approx_norm: bool = True

    # precision: the hybrid f32 race -> f64 polish (default), or one
    # program in dtype
    dtype: str = "float64"
    hybrid_precision: bool = True
    hybrid_switch_factor: float = 10.0
    tp_shards: int = 0
    subspace_accept_always: bool = False
    chunk_iters: int = 0  # 0 = the port's default chunk
    power_iters: int = 50
    linop: str = "auto"  # "auto" | "dense" | "ell" | "coo"
    use_lanczos: bool = True
    full_eig_max_side: int = 1024
    square_form: bool = True
    mixed_projection: bool = False

    # persistent-subspace projection (subspace_sign: kernel K17 in an f32
    # program; subspace_accept_always: kernel K12 at B = 1 in solve)
    subspace_rank: int = 0
    subspace_tol: float = 1e-9
    subspace_reseed_freq: int = 256
    subspace_rel_accept: float = 0.1
    subspace_accept_cap: float = 1e-3
    subspace_sign: bool = False
    subspace_mixed: bool = True
    subspace_mixed_tol: float = 4e-6
    polish_subspace: bool = True
    race_subspace: bool = True
    race_subspace_warmup: int = 100
    projection: str = "auto"  # "auto" | "eigh" | "polar"
    polar_aggressive: int = 7
    polar_polish: int = 4
    polar_min_side: int = 100
    subspace_fallback: str = "eigh"
    polar_fallback_min_side: int = 384
    polish_subspace_guard: int = 8
    polish_restart: bool = True

    # adaptive restart-to-average
    restart: str = "adaptive"  # "none" | "adaptive"
    restart_window: int = 500
    restart_decay: float = 0.8
    restart_trigger: str = "gap"  # "gap" | "kkt"

    # checkpoint/resume: utils/checkpoint.py, the JAX package's format
    checkpoint_path: str = ""
    checkpoint_freq: int = 0

    def __post_init__(self):
        if self.dtype not in ("float64", "float32"):
            raise ValueError(f"dtype must be float64|float32, got {self.dtype}")
        if self.restart not in ("none", "adaptive"):
            raise ValueError(f"restart must be none|adaptive, got {self.restart}")
        if self.restart_trigger not in ("gap", "kkt"):
            raise ValueError(
                f"restart_trigger must be gap|kkt, got {self.restart_trigger}"
            )
        if isinstance(self.block_equilibration, str):
            low = self.block_equilibration.lower()
            if low != "auto":
                if low not in ("1", "true", "yes", "on",
                               "0", "false", "no", "off"):
                    raise ValueError(
                        "block_equilibration must be True|False|'auto', "
                        f"got {self.block_equilibration!r}"
                    )
                object.__setattr__(
                    self, "block_equilibration",
                    low in ("1", "true", "yes", "on"),
                )
        elif self.block_equilibration not in (True, False):
            raise ValueError(
                "block_equilibration must be True|False|'auto', got "
                f"{self.block_equilibration!r}"
            )

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    @property
    def max_iter_local(self) -> Optional[int]:
        return None


_FIELD_NAMES = {f.name for f in dataclasses.fields(Options)}


def make_options(**kwargs) -> Options:
    """Build Options, erroring on unknown names (src/MOI_wrapper.jl:84-103)."""
    unknown = set(kwargs) - _FIELD_NAMES
    if unknown:
        raise ValueError(f"Unknown option(s): {sorted(unknown)}")
    return Options(**kwargs)
