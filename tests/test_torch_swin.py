"""icm_tpu_torch's Swin stack against the JAX package's flax modules.

Each JAX module is initialised from a seed, its parameters moved off
their init (``test_torch_layers._perturb``) and carried over with
``convert.from_jax_params``; both run the same numpy input, NHWC on both
sides (``PatchEmbed`` takes the port's NCHW image). The Swin blocks run
the JAX side both ways it runs on a CPU: its jnp attention (bias and
shifted-window mask added apart) and, forced, the Pallas kernel in
interpret mode (at <= 256 windows, where the JAX module takes it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_layers import _load, _perturb, _run_jax, _x

from icm_tpu.nn import swin as jswin
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.nn import swin as tswin

torch.set_num_threads(2)

# f32 on both sides, sums in another order: a few ulps of O(1) outputs per
# layer. A Swin block chains two LayerNorms, four dense layers and an
# attention; flax's LayerNorm takes the variance as E[x^2] - E[x]^2 and
# torch's in two passes, a difference of an ulp or two of the variance at
# these means.
TOL = 1e-5
TOL_BLOCK = 5e-5


def _port(module, params, x_nhwc, *args):
    port = _load(module, params)
    with torch.no_grad():
        return port(torch.from_numpy(x_nhwc), *args).numpy()


def test_mlp():
    x = _x((2, 5, 7, 12), 1)
    m = jswin.Mlp(hidden=48, out=12)
    params = _perturb(m.init(jax.random.PRNGKey(0), x)["params"], 2)
    out = _port(tswin.Mlp(12, 48, 12), params, x)
    np.testing.assert_allclose(out, _run_jax(m, params, x), atol=TOL, rtol=TOL)


# (dim, heads, window, shift, H, W): head width 16 as in stf; a map of
# whole windows, with and without the shift, and a ragged 10 x 6 map
# padded to 12 x 8 before the shift
BLOCKS = [(32, 2, 4, 0, 8, 8), (32, 2, 4, 2, 8, 8), (32, 2, 4, 2, 10, 6),
          (48, 3, 4, 0, 10, 6)]


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("dim,heads,ws,ss,H,W", BLOCKS)
def test_swin_block(dim, heads, ws, ss, H, W, pallas):
    x = _x((2, H, W, dim), 3)
    m = jswin.SwinBlock(dim=dim, num_heads=heads, window_size=ws, shift_size=ss)
    params = _perturb(m.init(jax.random.PRNGKey(1), x)["params"], 4)
    ref = _run_jax(m, params, x, pallas=pallas)
    out = _port(tswin.SwinBlock(dim, heads, ws, ss), params, x)
    assert out.shape == (2, H, W, dim)
    np.testing.assert_allclose(out, ref, atol=TOL_BLOCK, rtol=TOL_BLOCK)


@pytest.mark.parametrize("H,W", [(6, 8), (7, 5)])
def test_patch_merging(H, W):
    """The 2x2 neighbours in flax's order (not pixel_unshuffle's), and an
    odd map padded."""
    x = _x((2, H, W, 8), 5)
    m = jswin.PatchMerging(dim=8)
    params = _perturb(m.init(jax.random.PRNGKey(2), x)["params"], 6)
    out = _port(tswin.PatchMerging(8), params, x)
    assert out.shape == (2, (H + 1) // 2, (W + 1) // 2, 16)
    np.testing.assert_allclose(out, _run_jax(m, params, x), atol=TOL, rtol=TOL)


def test_patch_split():
    x = _x((2, 3, 5, 16), 7)
    m = jswin.PatchSplit(dim=16)
    params = _perturb(m.init(jax.random.PRNGKey(3), x)["params"], 8)
    out = _port(tswin.PatchSplit(16), params, x)
    assert out.shape == (2, 6, 10, 8)
    np.testing.assert_allclose(out, _run_jax(m, params, x), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("H,W", [(8, 12), (9, 10)])
def test_patch_embed(H, W):
    """NCHW image in, NHWC features out; a size that is not a multiple of
    the patch is padded."""
    x = _x((2, H, W, 3), 9)
    m = jswin.PatchEmbed(patch_size=2, embed_dim=16)
    params = _perturb(m.init(jax.random.PRNGKey(4), x)["params"], 10)
    port = _load(tswin.PatchEmbed(3, 2, 16), params)
    with torch.no_grad():
        out = port(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    assert out.shape == (2, (H + 1) // 2, (W + 1) // 2, 16)
    np.testing.assert_allclose(out, _run_jax(m, params, x), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("downsample", [None, "merge", "split"])
def test_basic_layer(downsample):
    """Two blocks (shift 0, then 2) and the down- or upsample."""
    x = _x((1, 8, 8, 32), 11)
    m = jswin.BasicLayer(dim=32, depth=2, num_heads=2, window_size=4,
                         drop_path=[0.0, 0.1], downsample=downsample)
    params = _perturb(m.init(jax.random.PRNGKey(5), x)["params"], 12, scale=0.02)
    ref = _run_jax(m, params, x, pallas=True)
    out = _port(tswin.BasicLayer(32, 2, 4, [0.0, 0.1], downsample=downsample), params, x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL_BLOCK, rtol=TOL_BLOCK)


def test_layernorm_scale_maps_to_weight():
    tree = {"LayerNorm_0": {"scale": np.full(4, 2.0, np.float32),
                            "bias": np.ones(4, np.float32)}}
    sd = from_jax_params(tree)
    assert set(sd) == {"LayerNorm_0.weight", "LayerNorm_0.bias"}
    assert torch.equal(sd["LayerNorm_0.weight"], torch.full((4,), 2.0))


# --- stochastic depth ---------------------------------------------------------


def test_drop_path_keep_rate_and_scale():
    """Per sample: kept with probability 1 - rate (within 5 standard
    deviations of a binomial over 20000 samples) and scaled by 1 / keep,
    else zero; the same seed gives the same masks."""
    rate, n = 0.25, 20000
    dp = tswin.DropPath(rate)
    x = torch.ones(n, 2, 3, 4)
    out = dp(x, torch.Generator().manual_seed(0))
    per_sample = out.reshape(n, -1)
    kept = per_sample[:, 0] != 0
    assert torch.equal(per_sample, per_sample[:, :1].expand_as(per_sample))
    assert torch.all(per_sample[kept] == 1 / (1 - rate))
    assert torch.all(per_sample[~kept] == 0)
    sd = np.sqrt(n * rate * (1 - rate))
    assert abs(int(kept.sum()) - n * (1 - rate)) < 5 * sd
    assert torch.equal(dp(x, torch.Generator().manual_seed(0)), out)


def test_drop_path_is_keyed_on_the_generator():
    """No generator: the identity, in training mode too. Rate 0: the
    identity, drawing nothing. Two calls on one generator: two
    independent draws."""
    x = torch.ones(64, 1, 1, 1)
    dp = tswin.DropPath(0.5).train()
    assert torch.equal(dp(x), x)
    g = torch.Generator().manual_seed(1)
    state = g.get_state()
    assert torch.equal(tswin.DropPath(0.0)(x, g), x)
    assert torch.equal(g.get_state(), state)
    assert not torch.equal(dp(x, g), dp(x, g))


def test_swin_block_draws_two_masks_from_the_generator():
    """One draw of a mask per sample for each branch (the JAX block's two
    ``dp`` calls); at a rate of 1 - 2^-20 both branches are dropped and the
    block is the identity; at rate 0 the generator is untouched."""
    x = torch.from_numpy(_x((2, 4, 4, 16), 13))
    block = tswin.SwinBlock(16, 1, 4, 0, drop_path=1 - 2 ** -20)
    g, twin = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    with torch.no_grad():
        assert torch.equal(block(x, g), x)
        torch.rand(2, generator=twin), torch.rand(2, generator=twin)
        assert torch.equal(g.get_state(), twin.get_state())
        tswin.SwinBlock(16, 1, 4, 0)(x, g)
    assert torch.equal(g.get_state(), twin.get_state())
