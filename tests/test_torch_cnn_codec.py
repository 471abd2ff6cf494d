"""The narrow WACNN slice: icm_tpu_torch against the JAX package.

WACNN at the widths of bench.py's degraded config (N=32, M=48, 6 slices,
narrow hyper and context stacks) on 64x64 images. The JAX twin's
parameters are drawn from a numpy seed and carried over with
``from_jax_params``; the eval forward is compared, the port's own
compress -> decompress must be bit-exact, and the port's y symbols are
compared with the JAX ``CharmCodec``'s on the same weights and input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu.models import CharmCodec as JaxCharmCodec
from icm_tpu.models import WACNN as JaxWACNN
from icm_tpu_torch import models as tmodels
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.nn import window_attention as twa

torch.set_num_threads(2)

NARROW = dict(
    N=32, M=48, num_slices=6, max_support_slices=5,
    hyper_enc_widths=(48, 44, 40, 36, 32),
    hyper_dec_widths=(32, 36, 40, 44, 48),
    cc_widths=(32, 24, 20, 16),
)


def _params_from_numpy(jm, x, seed):
    """Parameters for the JAX twin drawn with numpy at the shapes of its
    init (``eval_shape``: the eager init of the whole model takes tens of
    seconds on a CPU): fan-in scaled kernels, small biases, GDN near its
    identity-like init; the bottleneck takes its own init, perturbed."""
    from icm_tpu.entropy import EntropyBottleneck

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                        jnp.asarray(x), training=False))["params"]

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        shape, name = leaf.shape, names[-1]
        n = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(shape[:-1]))
        if name == "bias":
            return 0.01 * n
        if name == "gamma":
            return np.sqrt(0.1 * np.eye(shape[0], dtype=np.float32) + 0.005 * np.abs(n))
        if name == "beta":
            return 1.0 + 0.05 * np.abs(n)
        return 0.02 * n  # relative-position tables

    eb_shapes = shapes.pop("entropy_bottleneck")
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    C = eb_shapes["quantiles"].shape[0]
    eb = EntropyBottleneck(C).init(
        {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(seed)},
        jnp.zeros((1, 2, 2, C)), training=False)["params"]
    params["entropy_bottleneck"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(eb))
    return {"params": params}


@pytest.fixture(scope="module")
def twins():
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    jm = JaxWACNN(**NARROW)
    variables = _params_from_numpy(jm, x, seed=1)
    tm = tmodels.create_model("cnn", device="cpu", **NARROW)
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return jm, variables, tm.eval(), x


def test_state_dict_covers_every_jax_parameter(twins):
    jm, variables, tm, _ = twins
    n_jax = len(jax.tree_util.tree_leaves(variables["params"]))
    assert n_jax == len(tm.state_dict())


def test_eval_forward_matches_jax(twins):
    jm, variables, tm, x = twins
    ref = jm.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    # f32 through ~60 layers, sums in another order on both sides
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]),
                               atol=1e-4, rtol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(out["likelihoods"][k].numpy(),
                                   np.asarray(ref["likelihoods"][k]),
                                   atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def port_codec(twins):
    _, _, tm, x = twins
    codec = tmodels.CharmCodec(tm)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    return codec, enc


def test_port_roundtrip_bitexact(twins, port_codec):
    _, _, _, x = twins
    codec, enc = port_codec
    assert len(enc["strings"][0]) == 2 and len(enc["strings"][1]) == 2
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    assert dec["x_hat"].shape == x.shape
    bits = sum(8 * len(s) for pair in enc["strings"] for s in pair)
    assert np.isfinite(bits / (2 * 64 * 64))


@pytest.fixture(scope="module")
def jax_codec(twins):
    jm, variables, _, x = twins
    jc = JaxCharmCodec(jm, variables)
    return jc, jc.compress(jnp.asarray(x), return_debug=True)


def test_symbols_against_jax_codec(port_codec, jax_codec):
    """Same weights, same input: the share of y symbols that differ from
    the JAX codec's. Cross-framework byte identity is not required (float
    order can flip a rounding boundary), so the share is bounded."""
    codec, enc = port_codec
    _, jenc = jax_codec
    # y_hat = sym + mu + lrp: a flipped symbol shows as a jump of ~1
    port_y = enc["y_hat"].permute(0, 2, 3, 1).numpy()
    jax_y = np.asarray(jenc["y_hat"])
    flipped = np.abs(port_y - jax_y) > 0.5
    share = flipped.mean()
    print(f"y symbols that differ from the JAX codec: {share:.2e} "
          f"({flipped.sum()} of {flipped.size}); identical y streams: "
          f"{enc['strings'][0] == jenc['strings'][0]}")
    assert share <= 1e-3
    np.testing.assert_allclose(port_y[~flipped], jax_y[~flipped], atol=1e-3)
    assert enc["strings"][1] == jenc["strings"][1]  # z: symbols before any context


class JaxHostWire:
    """JAX's host wire (``CharmCodec``'s own group compress and decompress)
    run on a JAX ``DeviceWireCodec``, which overrides only those two (and
    turns off the host wire's packed symbol fetch, turned on here for the
    call), so that the two wires share its compiled functions; every other
    attribute is the codec's."""

    def __init__(self, codec):
        self.codec = codec

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def compress(self, x, return_debug: bool = False):
        self.codec._wants_packed = True
        try:
            return JaxCharmCodec._compress_group(self.codec, x, return_debug)
        finally:
            self.codec._wants_packed = False

    def decompress(self, strings, shape):
        return JaxCharmCodec._decompress_group(self.codec, *strings, shape)


# Cross decoding: a decoder recomputes each slice's mean and scale index
# in its own framework, so its y_hat = symbol + mean is the encoder's to
# float order (f32 sums in another order, a few ulps of O(1) values),
# while a wrong symbol or a lost stream shows as a jump of 1 or more.
CROSS_TOL = 1e-4


def test_port_decodes_the_jax_codec_strings(twins, port_codec, jax_codec):
    _, _, _, x = twins
    codec, _ = port_codec
    _, jenc = jax_codec
    dec = codec.decompress(jenc["strings"], jenc["shape"])
    jax_y = np.asarray(jenc["y_hat"])
    np.testing.assert_allclose(dec["y_hat"].permute(0, 2, 3, 1).numpy(), jax_y,
                               rtol=0, atol=CROSS_TOL)
    assert dec["x_hat"].shape == x.shape


def test_jax_codec_decodes_the_port_strings(twins, port_codec, jax_codec):
    _, _, _, x = twins
    _, enc = port_codec
    jc, _ = jax_codec
    dec = jc.decompress(enc["strings"], enc["shape"])
    np.testing.assert_allclose(np.asarray(dec["y_hat"]),
                               enc["y_hat"].permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=CROSS_TOL)
    # the synthesis of the same y_hat, held as the eval forward is above
    np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert np.asarray(dec["x_hat"]).shape == x.shape


def test_full_width_eval_forward_matches_jax():
    """The full-width WACNN (N=192, M=320, 10 slices: the JAX package's
    defaults) against its JAX twin on one 64 x 64 image, as the narrow
    twins are held above."""
    x = np.random.default_rng(3).random((1, 64, 64, 3)).astype(np.float32)
    jm = JaxWACNN()
    variables = _params_from_numpy(jm, x, seed=4)
    tm = tmodels.create_model("cnn", device="cpu")
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    ref = jm.apply(variables, jnp.asarray(x), training=False)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    # f32 through ~70 layers, sums of up to 320 x 25 terms in another order
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]),
                               atol=1e-4, rtol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(out["likelihoods"][k].numpy(),
                                   np.asarray(ref["likelihoods"][k]),
                                   atol=1e-5, rtol=1e-4)


def test_narrow_setting_round_trips(twins):
    _, _, tm, x = twins
    codec = tmodels.CharmCodec(tm, narrow=0.25)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.create_model("cnn", **NARROW)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.resolve_device(None)
    assert tmodels.resolve_device("cpu").type == "cpu"


def test_cpu_forward_never_counts_a_launch(twins):
    _, _, tm, x = twins
    before = twa.LAUNCHES.copy()
    with torch.no_grad():
        tm(torch.from_numpy(x[:1]))
    assert twa.LAUNCHES == before
