"""The stf8-like narrow twin of the zigzag Swin family under the bfloat16
policy against the JAX package's (the tests of
``test_torch_stf_family_paths.FamilyBf16Twin``, in a file of their own so
that the suite's workers run the twins side by side)."""

from test_torch_stf_family_paths import FamilyBf16Twin


class TestStf8LikeBf16(FamilyBf16Twin):
    name = "stf8like"
