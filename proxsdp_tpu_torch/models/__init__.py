"""Model generators (``proxsdp_tpu/models``): max-cut, MIMO detection,
random dense SDPs, SDPLIB instances and sensor localisation."""

from . import maxcut, mimo, randsdp, sdplib, sensorloc  # noqa: F401
from .maxcut import maxcut_problem, random_graph_weights, solve_maxcut  # noqa: F401
from .mimo import mimo_problem, solve_mimo  # noqa: F401
from .randsdp import randsdp_problem, solve_randsdp  # noqa: F401
from .sdplib import sdplib_problem, solve_sdplib  # noqa: F401
from .sensorloc import sensorloc_problem, solve_sensorloc  # noqa: F401
