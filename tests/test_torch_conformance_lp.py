"""The conformance battery's LP and SOC cases through the port.

Each class subclasses its JAX test class (tests/test_conformance.py,
tests/test_conformance_ext.py) and runs the same case, with the same
known answer, against the port's API on the CPU (``_torch_conformance``).
"""

import _torch_conformance as tc
import test_conformance as jc
import test_conformance_ext as jce

_bind_port = tc.port_fixture(jc, jce)


class TestLP(jc.TestLP):
    pass


class TestSOC(jc.TestSOC):
    pass


class TestRotatedSOC(jc.TestRotatedSOC):
    pass


class TestLinearExt(jce.TestLinearExt):
    pass


class TestMaximizeDuals(jce.TestMaximizeDuals):
    pass


class TestSOCExt(jce.TestSOCExt):
    pass


class TestQuadraticBridge(jce.TestQuadraticBridge):
    pass
