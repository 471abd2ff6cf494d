"""The stf2 narrow twin with mask window 2 and 3 sliding tokens (32 tokens
of D = 32, the history sliding from token 4 on) against the JAX package:
the tests of ``test_torch_masked_stf2.Stf2Twin``, in a file of their own
so that the suite's workers run the twins side by side."""

from test_torch_masked_stf2 import Stf2Twin


class TestStf2Like(Stf2Twin):
    config = {"mask_win_size": 2, "num_sliding": 3}
