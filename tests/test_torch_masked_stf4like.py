"""The stf4 narrow twin (a sliding window of 8) against the JAX package:
the tests of ``test_torch_masked.MaskedTwin``, its codec with
``causal=True`` (the reference mask lets token 0 see every token) and its
training step through the reference mask, as the JAX package trains it."""

from test_torch_masked import MaskedTwin


class TestStf4Like(MaskedTwin):
    name = "stf4"
    config = {"causal": True, "sliding": 8}
    train_config = {"causal": False}
