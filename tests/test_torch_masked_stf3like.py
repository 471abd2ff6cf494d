"""The stf3 narrow twin with the reference's -1000 block mask (the
registry's default) against the JAX package: the tests of
``test_torch_masked.MaskedTwin``, in a file of their own so that the
suite's workers run the twins side by side."""

from test_torch_masked import MaskedTwin


class TestStf3Like(MaskedTwin):
    name = "stf3"
