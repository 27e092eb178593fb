"""Model generators: max-cut and randsdp (the other families are ROADMAP
A9)."""

from . import maxcut, randsdp  # noqa: F401
from .maxcut import maxcut_problem, random_graph_weights, solve_maxcut  # noqa: F401
from .randsdp import randsdp_problem, solve_randsdp  # noqa: F401
