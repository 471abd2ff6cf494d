"""The stf5-like narrow twin of the zigzag Swin family against the JAX
package (the tests of ``test_torch_stf_family.FamilyTwin``, in a file of
their own so that the suite's workers run the twins side by side)."""

from test_torch_stf_family import FamilyTwin


class TestStf5Like(FamilyTwin):
    name = "stf5like"
