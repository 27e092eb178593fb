"""Packed scaled triangle <-> square maps (``proxsdp_tpu/ops/tri.py``).

The packed vector stores off-diagonal entries multiplied by sqrt(2) (the
"scaled triangle" of the reference, src/prox_operators.jl:1-31), so
triangle -> square divides the off-diagonals by sqrt(2) and square ->
triangle multiplies them back.  Both directions are one gather with a
static index map and a static scale (``_maps``, built on the host once per
side).  They live with kernel K10 in ``kernels`` and take a leading
instance axis: on a CUDA tensor they launch K10, on the CPU they run its
plain PyTorch version.
"""

from __future__ import annotations

from ..kernels import _maps, square_to_tri, tri_to_square  # noqa: F401
from ..utils.vech import sympackedlen


def tri_len(side: int) -> int:
    return sympackedlen(side)
