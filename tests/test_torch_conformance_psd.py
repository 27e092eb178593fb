"""The conformance battery's PSD and degenerate cases through the port.

Each class subclasses its JAX test class (tests/test_conformance.py,
tests/test_conformance_ext.py) and runs the same case, with the same
known answer, against the port's API on the CPU (``_torch_conformance``).
"""

import _torch_conformance as tc
import test_conformance as jc
import test_conformance_ext as jce

_bind_port = tc.port_fixture(jc, jce)


class TestPSD(jc.TestPSD):
    pass


class TestCheckDualFeasMode(jc.TestCheckDualFeasMode):
    pass


class TestPSDExt(jce.TestPSDExt):
    pass


class TestDegenerate(jce.TestDegenerate):
    pass
