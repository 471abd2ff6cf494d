"""``stf4`` under the bfloat16 activation policy against JAX's: the tests
of ``test_torch_masked.OneShotBf16Twin`` on a narrow twin (4 slices, mask
window 2, a sliding window of 5: 16 tokens of D = 64), its codec on the
causal model and its training forward the reference mask's, in a file of
its own so that the suite's workers run the twins side by side."""

from test_torch_masked import OneShotBf16Twin


class TestStf4Bf16(OneShotBf16Twin):
    name = "stf4"
    config = {"num_slices": 4, "mask_win_size": 2, "sliding": 5, "causal": True}
    train_config = {"causal": False}
