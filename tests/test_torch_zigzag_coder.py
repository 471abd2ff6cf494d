"""The zigzag ChARM coding layer (``models/zigzag_coder.py``) alone against
the JAX package's ``ZigzagCharmCoder`` built as the CRC models build it,
without LRP (``apply_lrp=False``).

The CRC twins hold the layer inside their models (``test_torch_crc*.py``);
here a narrow layer
(24 channels, 2 x 2x2 zigzag = 8 slices of 3, sliding support 4, a
conditioning window of 6 blocks, clamped at the tail) runs both ways on
a random latent: its parameters, drawn with numpy at the shapes of the
JAX init, carried over with ``from_jax_params``; the eval loop's y_hat
and likelihoods within 1e-5; the stacked, zero-padded context weights
(``zz_scan``) bit for bit with JAX's ``stack_zigzag_params``, and
unstacked back to the per-slice weights; the port's eval loop against
JAX's ``code_scan`` on the stacked tree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu.models.zigzag_coder import ZigzagCharmCoder as JaxCoder
from icm_tpu.models.zigzag_coder import stack_zigzag_params as jax_stack
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.zigzag_coder import (ZigzagCharmCoder, stack_zigzag_params,
                                               unstack_zigzag_params)

torch.set_num_threads(2)

LAYER = dict(latent_dim=24, num_slices=2, max_support=4, support_num=6,
             hyper_enc_widths=(24, 20, 16, 14, 12), hyper_dec_widths=(14, 16, 20, 24, 24),
             cc_widths=(20, 12))


@pytest.fixture(scope="module")
def layers():
    """-> (JAX layer, its parameters, the port's layer with them, y NHWC)."""
    rng = np.random.default_rng(7)
    y = (4 * rng.standard_normal((2, 8, 8, 24))).astype(np.float32)
    jm = JaxCoder(**LAYER, apply_lrp=False)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.asarray(y),
        training=False, method=jm.code))["params"]
    eb = jax.device_get(shapes.pop("entropy_bottleneck"))
    params = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))).astype(
            np.float32) if len(a.shape) == 4 else (0.01 * rng.standard_normal(a.shape)).astype(
            np.float32), shapes)
    init = jm.init({"params": jax.random.PRNGKey(2), "noise": jax.random.PRNGKey(3)},
                   jnp.asarray(y), training=False, method=jm.code)["params"]
    params["entropy_bottleneck"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(init["entropy_bottleneck"]))
    assert jax.tree_util.tree_map(np.shape, eb) == jax.tree_util.tree_map(
        np.shape, params["entropy_bottleneck"])
    with torch.device("meta"):
        tm = ZigzagCharmCoder(**LAYER)
    tm = tm.to_empty(device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm.eval(), y


def test_state_dict_is_the_jax_tree(layers):
    jm, params, tm, _ = layers
    assert len(jax.tree_util.tree_leaves(params)) == len(tm.state_dict())
    assert not any(k.startswith("lrp_") for k in tm.state_dict())


def test_eval_loop_matches_jax(layers):
    """y_hat and both likelihoods of ``code`` without noise within 1e-5."""
    jm, params, tm, y = layers
    y_hat, lik = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False,
                                               method=jm.code))(params, jnp.asarray(y))
    with torch.no_grad():
        got_hat, got = tm.code(torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_hat.permute(0, 2, 3, 1).numpy(), np.asarray(y_hat),
                               rtol=0, atol=1e-5)
    for k in "yz":
        np.testing.assert_allclose(got[k].numpy(), np.asarray(lik[k]), rtol=0, atol=1e-5)


def test_stacked_context_weights_match_jax(layers):
    jm, params, tm, _ = layers
    want = jax_stack(params, tm.ctx_slices, tm.slice_ch, tm.max_support, tm.cond_width,
                     apply_lrp=False)["zz_scan"]
    got = stack_zigzag_params(params, tm)["zz_scan"]
    port = stack_zigzag_params(tm, tm)["zz_scan"]
    assert set(got) == set(want) == set(port) == {"cc_mean", "cc_scale"}
    for tag in want:
        for ln, p in want[tag].items():
            np.testing.assert_array_equal(got[tag][ln]["kernel"].numpy(), np.asarray(p["kernel"]))
            np.testing.assert_array_equal(port[tag][ln]["weight"].numpy(),
                                          np.transpose(np.asarray(p["kernel"]), (0, 4, 3, 1, 2)))
    back = unstack_zigzag_params({"zz_scan": port}, tm)
    sd = tm.state_dict()
    assert {f"{n}.{ln}.{leaf}" for n, layers_ in back.items() for ln, leaves in layers_.items()
            for leaf in leaves} == {k for k in sd if k.startswith("cc_")}
    for name, layers_ in back.items():
        for ln, leaves in layers_.items():
            for leaf, v in leaves.items():
                assert torch.equal(v, sd[f"{name}.{ln}.{leaf}"]), (name, ln, leaf)


def test_scan_eval_loop_matches_jax_code_scan(layers):
    """The port's ``code`` against JAX's ``scan=True`` layer (``code_scan``
    over the stacked, zero-padded tree): y_hat and both likelihoods within
    1e-5."""
    _, params, tm, y = layers
    js = JaxCoder(**LAYER, apply_lrp=False, scan=True)
    tree = {k: v for k, v in params.items() if k.rsplit("_", 1)[0] not in ("cc_mean", "cc_scale")}
    tree.update(jax_stack(params, tm.ctx_slices, tm.slice_ch, tm.max_support, tm.cond_width,
                          apply_lrp=False))
    y_hat, lik = jax.jit(lambda p, a: js.apply({"params": p}, a, training=False,
                                               method=js.code))(tree, jnp.asarray(y))
    with torch.no_grad():
        got_hat, got = tm.eval().code(torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_hat.permute(0, 2, 3, 1).numpy(), np.asarray(y_hat),
                               rtol=0, atol=1e-5)
    for k in "yz":
        np.testing.assert_allclose(got[k].numpy(), np.asarray(lik[k]), rtol=0, atol=1e-5)

