"""Reference checkpoints of the zigzag family with window-8 refiners
(``stf7`` and ``stf8``): the checks of ``test_torch_zoo.py``
at each preset's slices, context and refiners, narrow widths."""

import pytest
from test_torch_zoo import (check_converter_tree_matches_init,
                            check_port_conversion_loads_strictly,
                            check_port_conversion_matches_jax)

PRESETS = ["stf7", "stf8"]


@pytest.mark.parametrize("name", PRESETS)
def test_converter_tree_matches_init(name):
    check_converter_tree_matches_init(name)


@pytest.mark.parametrize("name", PRESETS)
def test_port_conversion_matches_jax(name):
    check_port_conversion_matches_jax(name)


@pytest.mark.parametrize("name", PRESETS)
def test_port_conversion_loads_strictly(name):
    check_port_conversion_loads_strictly(name)

