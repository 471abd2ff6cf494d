"""The stf3 narrow twin with ``causal=True`` (a boolean lower-triangular
mask over the whole context sequence) against the JAX package: the tests
of ``test_torch_masked.MaskedTwin``."""

from test_torch_masked import MaskedTwin


class TestStf3LikeCausal(MaskedTwin):
    name = "stf3"
    config = {"causal": True}
