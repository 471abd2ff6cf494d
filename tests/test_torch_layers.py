"""icm_tpu_torch layers against the JAX package's flax modules.

Each JAX module is initialised from a seed, its parameters are carried
over with ``convert.from_jax_params``, and both run the same numpy input
(NHWC on the JAX side, NCHW on the port's). The window blocks run the
JAX side with the Pallas kernel forced on in interpret mode, as
tests/test_pallas_kernels.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from icm_tpu import nn as jnn
from icm_tpu.nn import layers as jlayers
from icm_tpu_torch import nn as tnn
from icm_tpu_torch.convert import from_jax_params

torch.set_num_threads(2)

# f32 on both sides, sums in another order: a few ulps of O(1) outputs
# per layer; the attention blocks chain 7 convs and an attention.
TOL = 1e-5
TOL_BLOCK = 5e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturb(params, seed, scale=0.05):
    """Move every parameter off its init (identity-like GDN, zero biases)
    so the comparison sees every weight."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * np.abs(rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(params),
    )


def _load(module, params, scope=None):
    """Load flax ``params`` into ``module``; ``scope`` names the flax
    module when the tree is the module's own (GDN_0, ConvTranspose_0 ...)."""
    sd = from_jax_params({scope: params} if scope else params)
    if scope:
        sd = {k.split(".", 1)[1]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _run_jax(module, params, x, pallas=False):
    if not pallas:
        return np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    jnn.set_use_pallas(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    finally:
        jnn.set_use_pallas(None)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn(inverse):
    C = 24
    x = _x((2, 8, 8, C), 1)
    m = jnn.GDN(C, inverse=inverse)
    params = _perturb(m.init(jax.random.PRNGKey(0), x)["params"], 2)
    ref = _run_jax(m, params, x)
    port = _load(tnn.GDN(C, inverse=inverse), params, "GDN_0")
    with torch.no_grad():
        out = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_deconv():
    x = _x((2, 5, 7, 12), 3)
    m = jnn.deconv(16, 5, 2)
    params = _perturb(m.init(jax.random.PRNGKey(1), x)["params"], 4)
    ref = _run_jax(m, params, x)
    assert ref.shape == (2, 10, 14, 16)
    port = _load(tnn.deconv(12, 16, 5, 2), params, "ConvTranspose_0")
    with torch.no_grad():
        out = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("r", [1, 2])
def test_subpel_conv(r):
    x = _x((1, 6, 6, 10), 5)
    m = jnn.SubpelConv(features=14, r=r)
    params = _perturb(m.init(jax.random.PRNGKey(2), x)["params"], 6)
    ref = _run_jax(m, params, x)
    port = _load(tnn.SubpelConv(10, 14, r=r), params)
    with torch.no_grad():
        out = _nhwc(port(_nchw(x)))
    assert out.shape == (1, 6 * r, 6 * r, 14)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def test_subpel_conv_kernel_size():
    """The 5x5 sub-pixel convolution of stf's synthesis head (``g_s.up``)."""
    x = _x((1, 6, 6, 10), 12)
    m = jnn.SubpelConv(features=8, r=2, kernel_size=5)
    params = _perturb(m.init(jax.random.PRNGKey(5), x)["params"], 13)
    ref = _run_jax(m, params, x)
    port = _load(tnn.SubpelConv(10, 8, r=2, kernel_size=5), params)
    with torch.no_grad():
        out = _nhwc(port(_nchw(x)))
    assert out.shape == (1, 12, 12, 8)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


# (dim, window, shift, H): the WACNN blocks at a small width and size
BLOCKS = [(16, 8, 4, 16), (24, 4, 2, 8), (16, 4, 0, 8)]


@pytest.mark.parametrize("dim,ws,ss,H", BLOCKS)
def test_win_based_attention(dim, ws, ss, H):
    x = _x((2, H, H, dim), 7)
    m = jnn.WinBasedAttention(dim=dim, num_heads=8, window_size=ws, shift_size=ss)
    params = _perturb(m.init(jax.random.PRNGKey(3), x)["params"], 8)
    ref = _run_jax(m, params, x, pallas=True)
    port = _load(tnn.WinBasedAttention(dim, 8, ws, ss), params)
    with torch.no_grad():
        out = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=TOL_BLOCK, rtol=TOL_BLOCK)


@pytest.mark.parametrize("dim,ws,ss,H", BLOCKS[:2])
def test_win_noshift_attention(dim, ws, ss, H):
    x = _x((1, H, H, dim), 9)
    m = jnn.Win_noShift_Attention(dim=dim, num_heads=8, window_size=ws, shift_size=ss)
    params = _perturb(m.init(jax.random.PRNGKey(4), x)["params"], 10, scale=0.02)
    ref = _run_jax(m, params, x, pallas=True)
    port = _load(tnn.Win_noShift_Attention(dim, 8, ws, ss), params)
    with torch.no_grad():
        out = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(out, ref, atol=TOL_BLOCK, rtol=TOL_BLOCK)


def test_window_helpers_match_jax():
    x = _x((2, 8, 16, 3), 11)
    parts = tnn.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(parts.numpy(),
                                  np.asarray(jlayers.window_partition(jnp.asarray(x), 4)))
    back = tnn.window_reverse(parts, 4, 8, 16)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(tnn.relative_position_index(4, 4),
                                  jlayers.relative_position_index(4, 4))
    np.testing.assert_array_equal(tnn.shifted_window_mask(16, 16, 8, 4),
                                  jlayers.shifted_window_mask(16, 16, 8, 4))
