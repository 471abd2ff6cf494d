"""The Swin codec ``stf``: icm_tpu_torch against the JAX package.

The narrow twin of ``tests/test_model_stf.py`` (embed 8, depths 1/1/2/1,
heads 1/2/4/8, 4 slices) on two 64x64 images, and the full-width model
(embed 48, depths 2/2/6/2, heads 3/6/12/24: the JAX package's defaults)
on one. The JAX twin's parameters are drawn with numpy at the shapes of
its init (``jax.eval_shape``: the eager init of the full-width model
takes about a minute on a CPU) and carried over with ``from_jax_params``.
Held: the eval forward, the port's host-wire round trip bit for bit, the
y symbols against the JAX ``CharmCodec``, decoding across the two
frameworks both ways, the device wire's blobs byte for byte with the JAX
``DeviceWireCodec``'s, one training step against JAX autodiff, and the
model's construction (LayerNorm init, CUDA by default).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL, JaxHostWire
from test_torch_train import _close, _replay

from icm_tpu.entropy import EntropyBottleneck
from icm_tpu.models import SymmetricalTransFormer as JaxSTF
from icm_tpu.models.device_codec import DeviceWireCodec as JaxDeviceWireCodec
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.nn import window_attention as twa

torch.set_num_threads(2)

# tests/test_model_stf.py's TINY
NARROW = dict(
    embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
    patch_size=2, num_slices=4, drop_path_rate=0.1,
    hyper_enc_widths=(64, 56, 48, 40, 32), hyper_dec_widths=(40, 48, 56, 64, 64),
    cc_widths=(24, 20, 16, 12),
)


def _params_from_numpy(jm, x, seed, *more_inputs):
    """Parameters for the JAX twin at the shapes of its init (on x and
    ``more_inputs``: czigzag's up_x4): every kernel, dense ones too,
    fan-in scaled (the attention sees O(1) logits, so the comparison sees
    the bias tables and the softmax); LayerNorm scales near one and small
    shifts; small biases; relative-position tables at 0.02; the bottleneck
    from its own init, perturbed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                        jnp.asarray(x), *map(jnp.asarray, more_inputs),
                        training=False))["params"]

    def draw(path, leaf):
        parent, name = (getattr(p, "key", "") for p in path[-2:])
        n = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(leaf.shape[:-1]))
        if parent.startswith("LayerNorm"):
            return 1.0 + 0.1 * n if name == "scale" else 0.05 * n
        if name == "bias":
            return 0.01 * n
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


def _port_model(params, **config):
    tm = tmodels.create_model("stf", device="cpu", **config)
    tm.load_state_dict(from_jax_params(params), strict=True)
    return tm.eval()


def _jax_eval(jm, variables, x):
    return jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, jnp.asarray(x))


def _assert_forward_close(out, ref):
    """x_hat within 1e-4, the likelihoods within 1e-5 absolute and 1e-4
    relative: the bars of the WACNN twins (f32 through 60-80 layers, sums
    in another order on both sides; flax's LayerNorm variance is
    E[x^2] - E[x]^2, torch's two-pass). Prints the largest differences."""
    err = {"x_hat": float(np.abs(out["x_hat"].numpy() - np.asarray(ref["x_hat"])).max())}
    for k in ("y", "z"):
        err[k] = float(np.abs(out["likelihoods"][k].numpy()
                              - np.asarray(ref["likelihoods"][k])).max())
    print(f"largest |port - JAX|: {err}; max |x_hat| {np.abs(np.asarray(ref['x_hat'])).max():.3f}")
    np.testing.assert_allclose(out["x_hat"].numpy(), np.asarray(ref["x_hat"]),
                               atol=1e-4, rtol=1e-4)
    for k in ("y", "z"):
        np.testing.assert_allclose(out["likelihoods"][k].numpy(),
                                   np.asarray(ref["likelihoods"][k]), atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def twins():
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    jm = JaxSTF(**NARROW)
    variables = _params_from_numpy(jm, x, seed=1)
    return jm, variables, _port_model(variables["params"], **NARROW), x


def test_state_dict_covers_every_jax_parameter(twins):
    _, variables, tm, _ = twins
    assert len(jax.tree_util.tree_leaves(variables["params"])) == len(tm.state_dict())


def test_eval_forward_matches_jax(twins):
    jm, variables, tm, x = twins
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    _assert_forward_close(out, _jax_eval(jm, variables, x))


def test_forward_without_generator_is_deterministic_in_training_mode(twins):
    """Stochastic depth and noise are keyed on the generator, not on
    ``self.training``: no generator, the eval forward's output."""
    _, _, tm, x = twins
    xs = torch.from_numpy(x[:1])
    with torch.no_grad():
        ref = tm.eval()(xs)
        got = tm.train()(xs)
        noisy = tm(xs, generator=torch.Generator().manual_seed(0))
    tm.eval()
    assert torch.equal(got["x_hat"], ref["x_hat"])
    assert not torch.equal(noisy["x_hat"], ref["x_hat"])


@pytest.fixture(scope="module")
def port_codec(twins):
    _, _, tm, x = twins
    codec = tmodels.CharmCodec(tm)
    return codec, codec.compress(torch.from_numpy(x), return_debug=True)


@pytest.fixture(scope="module")
def jax_device_codec(twins):
    """One JAX codec for both wires, which share its compiled functions."""
    jm, variables, _, _ = twins
    return JaxDeviceWireCodec(jm, variables, lanes_per_image=4)


@pytest.fixture(scope="module")
def jax_codec(twins, jax_device_codec):
    jc = JaxHostWire(jax_device_codec)
    return jc, jc.compress(jnp.asarray(twins[3]), return_debug=True)


def test_port_roundtrip_bitexact(twins, port_codec):
    _, _, _, x = twins
    codec, enc = port_codec
    assert len(enc["strings"][0]) == 2 and len(enc["strings"][1]) == 2
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    assert dec["x_hat"].shape == x.shape


def test_symbols_against_jax_codec(port_codec, jax_codec):
    """The share of y symbols that differ from the JAX codec's on the same
    weights and input, bounded as for WACNN (a float-order difference can
    flip a rounding boundary); z's stream is identical."""
    _, enc = port_codec
    _, jenc = jax_codec
    port_y = enc["y_hat"].permute(0, 2, 3, 1).numpy()
    jax_y = np.asarray(jenc["y_hat"])
    flipped = np.abs(port_y - jax_y) > 0.5
    print(f"y symbols that differ from the JAX codec: {flipped.mean():.2e} "
          f"({flipped.sum()} of {flipped.size}); identical y streams: "
          f"{enc['strings'][0] == jenc['strings'][0]}")
    assert flipped.mean() <= 1e-3
    np.testing.assert_allclose(port_y[~flipped], jax_y[~flipped], atol=1e-3)
    assert enc["strings"][1] == jenc["strings"][1]


def test_port_decodes_the_jax_codec_strings(twins, port_codec, jax_codec):
    _, _, _, x = twins
    codec, _ = port_codec
    _, jenc = jax_codec
    dec = codec.decompress(jenc["strings"], jenc["shape"])
    np.testing.assert_allclose(dec["y_hat"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jenc["y_hat"]), rtol=0, atol=CROSS_TOL)
    assert dec["x_hat"].shape == x.shape


def test_jax_codec_decodes_the_port_strings(twins, port_codec, jax_codec):
    _, _, _, x = twins
    _, enc = port_codec
    jc, _ = jax_codec
    dec = jc.decompress(enc["strings"], enc["shape"])
    np.testing.assert_allclose(np.asarray(dec["y_hat"]),
                               enc["y_hat"].permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=CROSS_TOL)
    np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(),
                               rtol=1e-4, atol=1e-4)


# --- the device wire ------------------------------------------------------------


@pytest.fixture(scope="module")
def port_wire(twins):
    _, _, tm, x = twins
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=4)
    return codec, codec.compress(torch.from_numpy(x), return_debug=True)


@pytest.fixture(scope="module")
def jax_wire(twins, jax_device_codec):
    return jax_device_codec, jax_device_codec.compress(jnp.asarray(twins[3]), return_debug=True)


def test_device_wire_roundtrip_bitexact(twins, port_wire, port_codec):
    """4 lanes of 4 pixels an image; y_hat equal to the host wire's."""
    codec, enc = port_wire
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    assert torch.equal(enc["y_hat"], port_codec[1]["y_hat"])


@pytest.mark.parametrize("stream", ["y", "z"])
def test_device_wire_bytes_match_jax(port_wire, jax_wire, stream):
    k = "yz".index(stream)
    for b, (got, want) in enumerate(zip(port_wire[1]["strings"][k], jax_wire[1]["strings"][k])):
        n_diff = sum(p != q for p, q in zip(got, want)) + abs(len(got) - len(want))
        assert got == want, f"{stream} wire of image {b}: {n_diff} bytes differ"


def test_device_wire_codes_once_a_slice(port_wire, monkeypatch):
    """What chip_smoke.py counts on the card: a compress encodes y and z in
    one call each; a decompress decodes z once and y once a slice (13 at
    stf's 12 slices, 11 at WACNN's 10)."""
    import icm_tpu_torch.models.device_codec as dc

    codec, enc = port_wire
    calls = {"encode": 0, "decode": 0}

    def counted(kind, fn):
        def call(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(dc, "encode_lanes", counted("encode", dc.encode_lanes))
    monkeypatch.setattr(dc, "decode_lanes", counted("decode", dc.decode_lanes))
    x = torch.from_numpy(np.random.default_rng(4).random((1, 64, 64, 3)).astype(np.float32))
    again = codec.compress(x)
    assert calls == {"encode": 2, "decode": 0}
    codec.decompress(again["strings"], again["shape"])
    assert calls == {"encode": 2, "decode": codec.model.ctx_slices + 1}


def test_port_decodes_the_jax_device_wire(port_wire, jax_wire):
    codec, _ = port_wire
    _, jenc = jax_wire
    dec = codec.decompress(jenc["strings"], jenc["shape"])
    np.testing.assert_allclose(dec["y_hat"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(jenc["y_hat"]), rtol=0, atol=CROSS_TOL)


# --- training -------------------------------------------------------------------


def test_train_step_matches_jax(twins, monkeypatch):
    """The narrow twin without stochastic depth (drop_path_rate 0: the
    masks cannot come from one generator on both sides), the same noise
    replayed into both: loss terms within 1e-5, every gradient within 1e-4
    of its max, as for WACNN (``test_torch_train.py``)."""
    _, variables, _, x = twins
    config = {**NARROW, "drop_path_rate": 0.0}
    jm = JaxSTF(**config)
    params = jax.device_get(variables["params"])
    rng = np.random.default_rng(5)
    sc = 8 * config["embed_dim"] // config["num_slices"]
    noise = [rng.uniform(-0.5, 0.5, (config["hyper_enc_widths"][-1], 1, 2)).astype(np.float32)]
    noise += [rng.uniform(-0.5, 0.5, (2, 4, 4, sc)).astype(np.float32)
              for _ in range(config["num_slices"])]
    tr, jr = _replay(monkeypatch, noise)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                       rngs={"noise": key, "dropout": key})
        rd = JaxRD(0.01)(out, jnp.asarray(x))
        aux = jm.apply({"params": p}, method=jm.aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert jr.i == len(noise)

    tm = _port_model(params, **config).train()
    out = tm(torch.from_numpy(x), generator=torch.Generator())
    rd = ttrain.RateDistortionLoss(0.01)(out, torch.from_numpy(x))
    aux = tm.aux_loss()
    (rd["loss"] + aux).backward()
    assert tr.i == len(noise)
    for k, v in {**rd, "aux_loss": aux}.items():
        _close(v.item(), ref_m[k], 1e-5, k)
    ref_grads = from_jax_params(jax.device_get(ref_g))
    worst = {name: _close(p.grad.numpy(), ref_grads[name].numpy(), 1e-4, name)
             for name, p in tm.named_parameters()}
    print("largest gradient error relative to its max:",
          max(worst.items(), key=lambda kv: kv[1]))


# --- full width and construction ------------------------------------------------


def test_full_width_eval_forward_matches_jax():
    """The full-width stf (99.9 M parameters) against its JAX twin on one
    64 x 64 image, at the narrow twins' bars."""
    x = np.random.default_rng(3).random((1, 64, 64, 3)).astype(np.float32)
    jm = JaxSTF()
    variables = _params_from_numpy(jm, x, seed=4)
    tm = _port_model(variables["params"])
    assert sum(p.numel() for p in tm.parameters()) == 99_855_639
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    _assert_forward_close(out, _jax_eval(jm, variables, x))


def test_create_model_initializes_layernorm_and_draws_from_the_seed():
    a = tmodels.create_model("stf", device="cpu", seed=3, **NARROW)
    norms = [m for m in a.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert len(norms) == 2 * 2 * 5 + 3 + 3 + 1  # two a block, merges, splits, embed
    assert all(torch.equal(m.weight, torch.ones_like(m.weight)) and
               torch.equal(m.bias, torch.zeros_like(m.bias)) for m in norms)
    b = tmodels.create_model("stf", device="cpu", seed=3, **NARROW)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.isfinite(p).all() and torch.equal(p, q), name
    table = a.g_a.layer0.block0.attn.relative_position_bias_table
    assert 0 < float(table.detach().std()) < 0.05


def test_create_model_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.create_model("stf", **NARROW)


def test_cpu_forward_never_counts_a_launch(twins):
    _, _, tm, x = twins
    before = twa.LAUNCHES.copy()
    with torch.no_grad():
        tm(torch.from_numpy(x[:1]))
    assert twa.LAUNCHES == before
