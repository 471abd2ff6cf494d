"""The zigzag scan: icm_tpu_torch.scan against icm_tpu.scan.

The orders (numpy, both packages) must be the same permutations for the
constrained lattices (stf6's) and the unconstrained ones (stf8's 6 x 2 x
2); split and merge must move the same elements, the port's NCHW against
JAX's NHWC on the same seeded tensor, and merge must invert split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu.scan import zigzag as jzz
from icm_tpu_torch.scan import zigzag as tzz

LATTICES = [(nC, n, n) for nC in (4, 5, 6) for n in (1, 2)] + [(6, 2, 2), (3, 4, 2), (2, 3, 5)]


@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("nC,nH,nW", LATTICES)
def test_orders_match_jax(nC, nH, nW, constrained):
    got = tzz.zigzag_order(nC, nH, nW, constrained)
    assert got == jzz.zigzag_order(nC, nH, nW, constrained)
    flat = tzz._flat_order(nC, nH, nW, constrained)
    np.testing.assert_array_equal(flat, jzz._flat_order(nC, nH, nW, constrained))
    np.testing.assert_array_equal(tzz.inverse_order(flat), jzz.inverse_order(flat))
    assert sorted(flat.tolist()) == list(range(nC * nH * nW))


def test_stf8_order_differs_from_stf6s():
    """stf8's unconstrained order on its 6 x 2 x 2 lattice is another
    permutation than the constrained one: the presets must not share it."""
    assert tzz.zigzag_order(6, 2, 2, False) != tzz.zigzag_order(6, 2, 2, True)


@pytest.mark.parametrize("constrained", [True, False])
@pytest.mark.parametrize("nS,nH,nW", [(4, 2, 2), (6, 2, 2), (3, 1, 1), (2, 2, 3)])
def test_split_and_merge_match_jax(nS, nH, nW, constrained):
    rng = np.random.default_rng(nS * 100 + nH * 10 + nW)
    B, C, H, W = 2, 4 * nS, 4 * nH, 6 * nW
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    got = tzz.zigzag_split(torch.from_numpy(x), nS, nH, nW, constrained)
    want = np.asarray(jzz.zigzag_split(jnp.asarray(x.transpose(0, 2, 3, 1)), nS, nH, nW,
                                       constrained))
    assert got.shape == (B, nS * nH * nW, C // nS, H // nH, W // nW)
    np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(), want)
    back = tzz.zigzag_merge(got, nS, nH, nW, constrained)
    np.testing.assert_array_equal(back.numpy(), x)
    jback = np.asarray(jzz.zigzag_merge(jnp.asarray(want), nS, nH, nW, constrained))
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), jback)


def test_split_rejects_shapes_that_do_not_divide():
    with pytest.raises(ValueError, match="does not split"):
        tzz.zigzag_split(torch.zeros(1, 6, 4, 4), 4, 2, 2)
