"""The examples/ scripts through the port: each example's ``build_and_solve``
runs with its module's ``px`` swapped for ``proxsdp_tpu_torch`` (on the
CPU), so the example files stay as they are; the bounds are
tests/test_examples.py's."""

import os
import sys
import types

import pytest

import _torch_parity as tp  # noqa: F401  (one torch thread)
import proxsdp_tpu_torch as tx

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


class _CpuOptimizer(tx.Optimizer):
    """The port's Optimizer, solving on the CPU (its default is the card)."""

    def optimize(self, warm_start=None, *, device="cpu", **kwargs):
        return super().optimize(warm_start, device=device, **kwargs)


@pytest.fixture
def port(monkeypatch):
    def swap(module):
        shim = types.SimpleNamespace(**{k: getattr(tx, k) for k in tx.__all__})
        shim.Optimizer = _CpuOptimizer
        monkeypatch.setattr(module, "px", shim)
        return module

    return swap


def test_optimizer_api_example(port):
    from examples import optimizer_api

    res, x, y = port(optimizer_api).build_and_solve(verbose=False)
    assert isinstance(res, tx.Result)
    assert res.status == 1
    # max 5x + 3y s.t. x <= 2, x + 5y <= 3 -> x=2, y=0.2 -> 10.6
    assert abs(res.objval - 10.6) < 5e-2
    assert abs(x - 2.0) < 1e-2 and abs(y - 0.2) < 1e-2


def test_sos_example(port):
    from examples import sos

    res, t = port(sos).build_and_solve()
    assert isinstance(res, tx.Result)
    assert res.status == 1
    # the JAX package's bound (tests/test_examples.py): the SOS lower bound
    # of the nonnegative, not-SOS polynomial near -0.177
    assert -0.185 < t < -0.170, t
