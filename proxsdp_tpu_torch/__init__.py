"""proxsdp_tpu_torch -- the PyTorch/CUDA port of ``proxsdp_tpu``.

A second package beside the JAX one, which stays the reference: module
names match (``solver``, ``ops/cones``, ``ops/linop``, ...), and each slice
is accepted only when it matches ``proxsdp_tpu`` on the same input.  It
imports ``torch``, numpy and scipy -- never jax, never ``proxsdp_tpu``.

Ported so far: solves of one square-form PSD block -- the default
``solve(problem)`` (the hybrid f32 race and f64 polish) and single f64
or f32 programs -- and the batched sweep ``solve_batch(problems)`` of
many same-geometry single-block problems (the packed-triangle layout,
the dense-eigh projection), with their hot work in hand-written CUDA
kernels (``kernels/csrc``).  ``solve`` and ``solve_batch`` run on the
CUDA card unless the caller passes ``device="cpu"``; every tensor has an
explicit dtype.
"""

from __future__ import annotations

from .api import Optimizer
from .options import Options, make_options
from .problem import ConeLayout, ConicProblem, preprocess
from .result import STATUS_STRINGS, TERMINATION_STATUS, Result
from .parallel.batch import solve_batch
from .solver import solve

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
    "solve_batch",
    "Optimizer",
]
