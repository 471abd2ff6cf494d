"""The stf13 narrow twin of the CRC family against the JAX package: its eval
forward, host wire and device wire, six streams (the tests of
``test_torch_crc.CRC3Twin``, in a file of their own so that the suite's
workers run the twins side by side)."""

from test_torch_crc import CRC3Twin


class TestStf13(CRC3Twin):
    name = "stf13"
