"""Reference checkpoints of the zigzag family with window-4 refiners
(``stf5``, ``stf6`` and ``stf6_2``): the checks of ``test_torch_zoo.py``
at each preset's slices, context and refiners, narrow widths."""

import pytest
from test_torch_zoo import (check_converter_tree_matches_init,
                            check_port_conversion_loads_strictly,
                            check_port_conversion_matches_jax, converted)

PRESETS = ["stf5", "stf6", "stf6_2"]


@pytest.mark.parametrize("name", PRESETS)
def test_converter_tree_matches_init(name):
    check_converter_tree_matches_init(name)


@pytest.mark.parametrize("name", PRESETS)
def test_port_conversion_matches_jax(name):
    check_port_conversion_matches_jax(name)


@pytest.mark.parametrize("name", PRESETS)
def test_port_conversion_loads_strictly(name):
    check_port_conversion_loads_strictly(name)


def test_stf6_drops_its_disabled_refiners():
    """stf6 builds sigma and LRP refiners its forward never runs: their
    tensors are in the reference dict and not in the conversion."""
    sd, _, port = converted("stf6")
    assert any(k.startswith("sigma_Swin.") for k in sd)
    assert any(k.startswith("mu_refine_") for k in port)
    assert not any(k.startswith(("sigma_refine_", "lrp_refine_")) for k in port)
