"""The stf9 narrow twin of the CRC family against the JAX package: its scan
wire, stacked context weights and training step (the tests of
``test_torch_crc.CRCScanTwin``, in a file of their own so that the
suite's workers run the twins side by side)."""

from test_torch_crc import CRCScanTwin


class TestStf9Scan(CRCScanTwin):
    name = "stf9"
