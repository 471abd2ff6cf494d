"""The stf9 narrow twin of the CRC family under the bfloat16 policy against
the JAX package's (the tests of ``test_torch_crc.CRCBf16Twin``, in a file of
their own so that the suite's workers run the twins side by side)."""

from test_torch_crc import CRCBf16Twin


class TestStf9Bf16(CRCBf16Twin):
    name = "stf9"
