"""The stf12 narrow twin of the CRC family against the JAX package: its scan
wire, stacked context weights and training steps (the tests of
``test_torch_crc.CRCScanTwin``, in a file of their own so that the
suite's workers run the twins side by side)."""

from test_torch_crc import CRCScanTwin


class TestStf12Scan(CRCScanTwin):
    name = "stf12"
