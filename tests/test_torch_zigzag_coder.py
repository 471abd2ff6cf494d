"""The zigzag ChARM coding layer (``models/zigzag_coder.py``) alone against
the JAX package's ``ZigzagCharmCoder`` built as the CRC models build it:
without LRP (``apply_lrp=False``: stf9, stf11, stf12, stf14) and with it
(stf13's two coders).

The CRC twins hold the layer inside their models (``test_torch_crc*.py``);
here a narrow layer
(24 channels, 2 x 2x2 zigzag = 8 slices of 3, sliding support 4, a
conditioning window of 6 blocks, clamped at the tail) runs both ways on
a random latent: its parameters, drawn with numpy at the shapes of the
JAX init, carried over with ``from_jax_params``; the eval loop's y_hat
and likelihoods within 1e-5; the stacked, zero-padded context weights
(``zz_scan``) bit for bit with JAX's ``stack_zigzag_params``, and
unstacked back to the per-slice weights; the port's eval loop against
JAX's ``code_scan`` on the stacked tree within 1e-5. With LRP the same
checks hold the ``lrp_{i}`` stacks (input: the mean support and the
slice), their stacked slot (the slice's channels at the tail of the
padded first conv) and the LRP step of the loop.
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


def _make_layers(lrp: bool):
    """-> (JAX layer, its parameters, the port's layer with them, y NHWC)."""
    rng = np.random.default_rng(7)
    y = (4 * rng.standard_normal((2, 8, 8, 24))).astype(np.float32)
    jm = JaxCoder(**LAYER, apply_lrp=lrp)
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
        tm = ZigzagCharmCoder(**LAYER, apply_lrp=lrp)
    tm = tm.to_empty(device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    return jm, params, tm.eval(), y


@pytest.fixture(scope="module")
def layers():
    return _make_layers(False)


@pytest.fixture(scope="module")
def lrp_layers():
    return _make_layers(True)


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



# --- with LRP (stf13's coders) ------------------------------------------------------

def _stacked_tree(params, tm, lrp: bool) -> dict:
    """The JAX tree of a ``scan=True`` layer: its context stacks stacked."""
    tags = ("cc_mean", "cc_scale") + (("lrp",) if lrp else ())
    tree = {k: v for k, v in params.items() if k.rsplit("_", 1)[0] not in tags}
    tree.update(jax_stack(params, tm.ctx_slices, tm.slice_ch, tm.max_support, tm.cond_width,
                          apply_lrp=lrp))
    return tree


def test_lrp_stacks_are_the_jax_tree(lrp_layers):
    """Each slice has an ``lrp_{i}`` stack whose first conv reads the mean
    support and the slice; the state dict is the JAX tree leaf for leaf."""
    jm, params, tm, _ = lrp_layers
    assert len(jax.tree_util.tree_leaves(params)) == len(tm.state_dict())
    assert tm.tags == ("cc_mean", "cc_scale", "lrp")
    for i in range(tm.ctx_slices):
        want = tm.cond_width + tm.slice_ch * (min(i, tm.max_support) + 1)
        assert getattr(tm, f"lrp_{i}").Conv_0.weight.shape[1] == want
        assert np.asarray(params[f"lrp_{i}"]["Conv_0"]["kernel"]).shape[2] == want


def test_lrp_eval_loop_matches_jax(lrp_layers):
    """``code`` with LRP, without noise: y_hat and both likelihoods within
    1e-5 of JAX's; and the LRP moves y_hat (the check would pass on a
    layer that skipped it otherwise)."""
    jm, params, tm, y = lrp_layers
    y_hat, lik = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False,
                                               method=jm.code))(params, jnp.asarray(y))
    with torch.no_grad():
        got_hat, got = tm.code(torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_hat.permute(0, 2, 3, 1).numpy(), np.asarray(y_hat),
                               rtol=0, atol=1e-5)
    for k in "yz":
        np.testing.assert_allclose(got[k].numpy(), np.asarray(lik[k]), rtol=0, atol=1e-5)
    frac = got_hat - torch.round(got_hat)
    assert float(frac.abs().max()) > 1e-3


def test_lrp_slot_stacks_and_unstacks_bit_for_bit(lrp_layers):
    """The stacked ``lrp`` slot (the slice's channels at the tail of the
    padded first conv) bit for bit with JAX's ``stack_zigzag_params``, from
    the JAX tree and from the port's state dict; unstacked, every stack
    the state dict's bit for bit; and JAX's unstacking of the port's
    stacked weights gives the JAX tree back."""
    from icm_tpu.models.zigzag_coder import unstack_zigzag_params as jax_unstack

    _, params, tm, _ = lrp_layers
    want = jax_stack(params, tm.ctx_slices, tm.slice_ch, tm.max_support, tm.cond_width,
                     apply_lrp=True)["zz_scan"]
    got = stack_zigzag_params(params, tm)["zz_scan"]
    port = stack_zigzag_params(tm, tm)["zz_scan"]
    assert set(got) == set(want) == set(port) == {"cc_mean", "cc_scale", "lrp"}
    sc, width = tm.slice_ch, tm.cond_width + tm.max_support * tm.slice_ch
    assert port["lrp"]["Conv_0"]["weight"].shape[2] == width + sc
    assert port["cc_mean"]["Conv_0"]["weight"].shape[2] == width
    for tag in want:
        for ln, p in want[tag].items():
            np.testing.assert_array_equal(got[tag][ln]["kernel"].numpy(), np.asarray(p["kernel"]))
            np.testing.assert_array_equal(port[tag][ln]["weight"].numpy(),
                                          np.transpose(np.asarray(p["kernel"]), (0, 4, 3, 1, 2)))
            np.testing.assert_array_equal(port[tag][ln]["bias"].numpy(), np.asarray(p["bias"]))
    back = unstack_zigzag_params({"zz_scan": port}, tm)
    sd = tm.state_dict()
    assert {f"{n}.{ln}.{leaf}" for n, layers_ in back.items() for ln, leaves in layers_.items()
            for leaf in leaves} == {k for k in sd if k.startswith(("cc_", "lrp_"))}
    for name, layers_ in back.items():
        for ln, leaves in layers_.items():
            for leaf, v in leaves.items():
                assert torch.equal(v, sd[f"{name}.{ln}.{leaf}"]), (name, ln, leaf)
    jback = jax_unstack({"zz_scan": got}, tm.ctx_slices, tm.slice_ch, tm.max_support,
                        tm.cond_width, apply_lrp=True)
    for name, layers_ in jback.items():
        for ln, p in layers_.items():
            np.testing.assert_array_equal(np.asarray(p["kernel"]),
                                          np.asarray(params[name][ln]["kernel"]))


def test_lrp_scan_eval_loop_matches_jax_code_scan(lrp_layers):
    """The port's ``code`` with LRP against JAX's ``scan=True`` layer
    (``code_scan``, its LRP inside the scanned step, over the stacked
    tree): y_hat and both likelihoods within 1e-5."""
    _, params, tm, y = lrp_layers
    js = JaxCoder(**LAYER, apply_lrp=True, scan=True)
    tree = _stacked_tree(params, tm, True)
    y_hat, lik = jax.jit(lambda p, a: js.apply({"params": p}, a, training=False,
                                               method=js.code))(tree, jnp.asarray(y))
    with torch.no_grad():
        got_hat, got = tm.code(torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got_hat.permute(0, 2, 3, 1).numpy(), np.asarray(y_hat),
                               rtol=0, atol=1e-5)
    for k in "yz":
        np.testing.assert_allclose(got[k].numpy(), np.asarray(lik[k]), rtol=0, atol=1e-5)


def test_lrp_tree_of_a_scanned_layer_converts(lrp_layers):
    """``from_jax_params`` of a scanned layer's tree (its ``zz_scan`` with the
    ``lrp`` slot), given the layer, is the unrolled tree's state dict."""
    _, params, tm, _ = lrp_layers
    got = from_jax_params(_stacked_tree(params, tm, True), model=tm)
    want = from_jax_params(params)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
