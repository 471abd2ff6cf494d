"""``stf3`` under the bfloat16 activation policy against JAX's: the tests
of ``test_torch_masked.OneShotBf16Twin`` on a narrow twin (4 slices, mask
window 4: 4 tokens of D = 256, the reference's block mask), in a file of
its own so that the suite's workers run the twins side by side."""

from test_torch_masked import OneShotBf16Twin


class TestStf3Bf16(OneShotBf16Twin):
    name = "stf3"
    config = {"num_slices": 4, "mask_win_size": 4}
