"""proxsdp_tpu_torch -- the PyTorch/CUDA port of ``proxsdp_tpu``.

A second package beside the JAX one, which stays the reference: module
names match (``solver``, ``ops/cones``, ``ops/linop``, ...), and each slice
is accepted only when it matches ``proxsdp_tpu`` on the same input.  It
imports ``torch``, numpy and scipy -- never jax, never ``proxsdp_tpu``.

Ported so far: solves of conic programs -- PSD blocks of any number and
side (the Lanczos projection above ``full_eig_max_side``) in the
square-form or the packed-triangle layout, SOC blocks, free and LP
coordinates, Ruiz and block equilibration with the
``block_equilibration="auto"`` probe, warm starts, checkpoints and
``resume_from``, the sign-based and the accept-always subspace steps,
the certificate search after an infeasible or unbounded declaration --
by the default
``solve(problem)`` (the hybrid f32 race and f64 polish) and single f64
or f32 programs, and the batched sweep ``solve_batch(problems)`` of
many same-geometry single-block problems (the packed-triangle layout,
the dense-eigh or subspace projection, one operator shared by every
instance or one per instance), with their hot work in hand-written CUDA
kernels (``kernels/csrc``); and the API over them: ``Optimizer`` with
``optimize`` and its MOI-style accessors, ``solve_sdp``, the SCS-form
``solve_cone_program`` (``ingest``) and ``cvxpy_interface``; and the
sharded solves over ``torch.distributed``, one process a rank
(``parallel.dist``): ``solve_batch(mesh=...)`` and
``parallel.sharded.solve_sharded``.  Every entry point runs on the CUDA
card unless the caller passes ``device="cpu"``; every tensor has an
explicit dtype.
"""

from __future__ import annotations

from .api import Optimizer, solve_sdp
from .ingest import ConeDims, ConeSolution, solve_cone_program
from .options import Options, make_options
from .problem import ConeLayout, ConicProblem, preprocess
from .result import STATUS_STRINGS, TERMINATION_STATUS, Result
from .parallel.batch import solve_batch
from .solver import solve
from .utils.vech import ivec, ivech, sympackedlen, vech

__all__ = [
    "Options",
    "make_options",
    "ConicProblem",
    "ConeLayout",
    "preprocess",
    "Result",
    "STATUS_STRINGS",
    "TERMINATION_STATUS",
    "solve",
    "solve_sdp",
    "solve_batch",
    "Optimizer",
    "ConeDims",
    "ConeSolution",
    "solve_cone_program",
    "ivec",
    "ivech",
    "vech",
    "sympackedlen",
]
