"""The stf12 narrow twin of the CRC family against the JAX package: its eval
forward, host wire and device wire (the tests of
``test_torch_crc.CRCTwin``, in a file of their own so that the suite's
workers run the twins side by side)."""

from test_torch_crc import CRCTwin


class TestStf12(CRCTwin):
    name = "stf12"
