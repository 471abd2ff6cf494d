"""The stf8-like narrow twin of the zigzag Swin family against the JAX
package: its scan wire, stacked weights and both training forwards (the
tests of ``test_torch_stf_family_paths.FamilyScanTwin``, in a file of their
own so that the suite's workers run the twins side by side)."""

from test_torch_stf_family_paths import FamilyScanTwin


class TestStf8LikeScan(FamilyScanTwin):
    name = "stf8like"
