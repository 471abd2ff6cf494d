"""The czigzag narrow twin on two 96 x 64 images against the JAX package:
a 6 x 4 latent, so the last Swin stage and the hyper stacks pad their
maps to the window (8 x 4), z is 3 x 2 and each zigzag block 3 x 2. The
tests of ``test_torch_czigzag.CzigzagTwin`` on the scan wire."""

from test_torch_czigzag import CzigzagTwin, pytest_generate_tests  # noqa: F401


class TestCzigzagPadded(CzigzagTwin):
    size = (96, 64)
    wires = ("scan",)
