"""Shared set-up of the conformance battery through the port (not a test
module).

``tests/test_conformance.py`` and ``tests/test_conformance_ext.py`` hold
the battery's known-answer cases for the JAX package; they reach it
through three module-level names, ``px``, ``solve_cone_program`` and
``ConeDims``.  The port's battery files subclass their test classes and,
through the autouse fixture below, bind those names to the port's entry
points on the CPU (``device="cpu"``, the plain PyTorch path) for the
duration of each case, so every case runs unchanged against the same
answers.  The JAX classes are only subclassed, never imported into a
port file's namespace, so they are not collected a second time.
"""

from __future__ import annotations

import functools
import types

import pytest
import torch

import proxsdp_tpu_torch as tx

# tiny problems: one thread (PyTorch's pool only contends with XLA's when
# the worker also runs the JAX package's tests)
torch.set_num_threads(1)


class CpuOptimizer(tx.Optimizer):
    """The port's Optimizer, solving on the CPU by default."""

    def optimize(self, warm_start=None, *, device="cpu", **kwargs):
        return super().optimize(warm_start, device=device, **kwargs)


PORT = types.SimpleNamespace(
    Optimizer=CpuOptimizer,
    make_options=tx.make_options,
    solve_sdp=functools.partial(tx.solve_sdp, device="cpu"),
)
solve_cone_program = functools.partial(tx.solve_cone_program, device="cpu")


def port_fixture(*modules):
    """An autouse fixture binding each JAX battery module's ``px``,
    ``solve_cone_program`` and ``ConeDims`` to the port's."""

    @pytest.fixture(autouse=True)
    def _bind_port(monkeypatch):
        for module in modules:
            monkeypatch.setattr(module, "px", PORT)
            monkeypatch.setattr(module, "solve_cone_program", solve_cone_program)
            monkeypatch.setattr(module, "ConeDims", tx.ConeDims)

    return _bind_port
