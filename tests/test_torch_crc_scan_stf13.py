"""The stf13 narrow twin of the CRC family against the JAX package: its scan
wire (both zigzag layers, LRP in the chain), stacked context weights with
the ``lrp`` slot and training steps (the tests of
``test_torch_crc.CRC3ScanTwin``, in a file of their own so that the
suite's workers run the twins side by side)."""

from test_torch_crc import CRC3ScanTwin


class TestStf13Scan(CRC3ScanTwin):
    name = "stf13"
