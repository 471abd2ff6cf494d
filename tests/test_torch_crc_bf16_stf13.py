"""The stf13 narrow twin of the CRC family under the bfloat16 policy against
the JAX package's (the tests of ``test_torch_crc.CRC3Bf16Twin``, in a file
of their own so that the suite's workers run the twins side by side)."""

from test_torch_crc import CRC3Bf16Twin


class TestStf13Bf16(CRC3Bf16Twin):
    name = "stf13"
