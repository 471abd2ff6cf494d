"""The CRC family ``stf9`` / ``stf11`` and ``stf14``: icm_tpu_torch against
the JAX package.

Narrow twins at ``tests/test_crc.py``'s ``TINY`` (N 16, M 24, mid 32, 2 x
2x2 zigzag = 8 slices, sliding support 4, a conditioning window of all 8
blocks, 2-conv context stacks) on two 64 x 64 images. The JAX twin's
parameters are drawn with numpy at the shapes of its init
(``jax.eval_shape``), GDN's and the bottlenecks' near their own inits,
and carried over with ``from_jax_params``. Each twin's tests run in files
of their own, so that the suite's workers run them side by side:

- ``test_torch_crc_stf9.py`` / ``_stf14.py`` (:class:`CRCTwin`): the eval
  forward (x_hat, machine_x_hat and all four likelihoods within 1e-4),
  the host wire's four streams byte for byte with JAX's ``CRCCodec`` and
  its y symbols identical, the device wire's blobs byte for byte with
  JAX's ``CRCCodec(wire="device")`` and its y_hat equal to the host
  wire's, decoding across the two frameworks both ways on both wires;
- ``test_torch_crc_scan_stf9.py`` / ``_stf14.py`` (:class:`CRCScanTwin`):
  the scan wire's blobs byte for byte with JAX's ``CRCCodec(
  scan_wire=True)`` (tier byte included), its round trip, cross decoding,
  y_hat against the device wire's within JAX's distribution bar
  (``tests/test_crc.py``), the stacked context weights against JAX's
  ``stack_zigzag_params`` and ``from_jax_params`` of a ``zz_scan`` tree,
  and one training step against JAX autodiff, both in float64, the noise
  replayed into both: loss terms within 1e-5, every gradient within 1e-4
  of its max.

The port's codecs take the JAX codecs' tables (``tables=``), as the zigzag
family's twins do (``test_torch_stf_family.py``): the bottlenecks' CDF
tables built in two frameworks from one density can differ by a step.
This file holds what the twins share and the family's tests that need
no twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL
from test_torch_stf_family import port_tables
from test_torch_stf_family_paths import GRAD_TOL, TERMS_TOL, _f64_port_params
from test_torch_train import _close, _replay

from icm_tpu.entropy import EntropyBottleneck
from icm_tpu.models import models as jax_models
from icm_tpu.models.crc_codec import CRCCodec as JaxCRCCodec
from icm_tpu.models.zigzag_coder import stack_zigzag_params as jax_stack
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.coding import WireFormatError
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.crc import ConditionalResidualCoding, ResidualCoding
from icm_tpu_torch.models.crc_codec import CRCCodec
from icm_tpu_torch.models.zigzag_coder import stack_zigzag_params, unstack_zigzag_params

torch.set_num_threads(2)

# tests/test_crc.py's TINY
TINY = dict(
    N=16, M=24, mid=32, num_slices=2, max_support=4, support_num=8,
    hyper_enc_widths=(24, 20, 16, 14, 12), hyper_dec_widths=(14, 16, 20, 24, 24),
    cc_widths=(20, 12),
)
# the eval forward of the two frameworks: f32 sums in another order
FORWARD_TOL = 1e-4


def _draw_params(jm, x, seed: int) -> dict:
    """Parameters for the JAX twin at the shapes of its init: kernels
    fan-in scaled (a transposed conv's by the taps an output sums), small
    biases, relative-position tables at 0.02; GDN's beta and gamma near
    their init (beta 1, gamma 0.1 I, stored
    reparametrized) with a positive perturbation; each bottleneck from
    its own init, perturbed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                        jnp.asarray(x), training=False))["params"]
    pedestal = 2.0 ** -36

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        parent, name = keys[-2], keys[-1]
        n = rng.standard_normal(leaf.shape, dtype=np.float32)
        if any(k.startswith("entropy_bottleneck") for k in keys):
            return None  # below
        if parent.startswith("GDN"):
            if name == "beta":
                return np.sqrt(1.0 + pedestal) + 0.1 * np.abs(n)
            eye = 0.1 * np.eye(leaf.shape[0], dtype=np.float32)
            return np.sqrt(eye + pedestal) + 0.01 * np.abs(n)
        if name == "kernel":
            # a stride-2 transposed conv sums a quarter of its taps per output
            gain = 2.0 if parent.startswith("ConvTranspose") else 1.0
            return gain * n / np.sqrt(np.prod(leaf.shape[:-1]))
        if name == "bias":
            return 0.01 * n
        return 0.02 * n  # relative-position tables

    params = jax.tree_util.tree_map_with_path(draw, shapes)

    def bottlenecks(tree, shape_tree):
        for k, v in shape_tree.items():
            if k.startswith("entropy_bottleneck"):
                C = v["quantiles"].shape[0]
                eb = EntropyBottleneck(C).init(
                    {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(seed)},
                    jnp.zeros((1, 2, 2, C)), training=False)["params"]
                tree[k] = jax.tree_util.tree_map(
                    lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
                        np.float32), jax.device_get(eb))
            elif isinstance(v, dict):
                bottlenecks(tree[k], v)

    bottlenecks(params, shapes)
    return {"params": jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)}


def make_twin(name: str, seed: int = 1):
    """-> (JAX model, its variables, the port's model with them, images)."""
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    jcls, jkw = jax_models[name]
    jm = jcls(**{**jkw, **TINY})
    variables = _draw_params(jm, x, seed)
    tm = tmodels.create_model(name, device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return jm, variables, tm.eval(), x


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def jax_tables(jcodec):
    return port_tables(jcodec.tables)


# --- the family's tests without a twin ---------------------------------------------

# parameters of the published widths: the JAX registry models' own counts
# (jax.eval_shape of their init)
FULL_WIDTH_PARAMS = {"stf9": 339_633_593, "stf11": 339_633_593, "stf14": 331_138_553}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_registry_builds_the_published_widths(name):
    """The port's registry holds the JAX package's class for each name at its
    defaults (stf11 is stf9's class): built on the meta device, each has
    the JAX model's parameter count, 24 zigzag slices of 64 channels, a
    conditioning window of 24 blocks, and no LRP stacks."""
    cls, kwargs = tmodels.models[name]
    jcls, jkwargs = jax_models[name]
    want = ResidualCoding if name == "stf14" else ConditionalResidualCoding
    assert cls is want and cls.__name__ == jcls.__name__ and kwargs == jkwargs == {}
    with torch.device("meta"):
        m = cls()
    assert sum(p.numel() for p in m.parameters()) == FULL_WIDTH_PARAMS[name]
    c = m.coder
    assert (c.ctx_slices, c.slice_ch, c.max_support, c.cond_blocks) == (24, 64, 12, 24)
    assert not any(n.startswith("lrp_") for n, _ in c.named_children())
    assert hasattr(m, "human_context_decoder") == (name != "stf14")


def test_stf11_is_stf9():
    assert tmodels.models["stf11"][0] is tmodels.models["stf9"][0]


@pytest.mark.parametrize("name", ["stf9", "stf14"])
def test_attention_and_gdn_widths_on_the_path(name):
    """The published widths put window attention at head widths 24 (g_a's
    first block), 48 (every 384-channel block) and 32 (the decoders'
    256-channel block), and GDN at 192 and 256 channels, on the path."""
    from icm_tpu_torch.nn import GDN, WinBasedAttention

    with torch.device("meta"):
        m = tmodels.models[name][0]()
    heads = {n.split(".")[0]: set() for n, _ in m.named_modules()}
    for n, mod in m.named_modules():
        if isinstance(mod, WinBasedAttention):
            heads[n.split(".")[0]].add(mod.attn.dim // mod.attn.num_heads)
    assert heads["machine"] == {24, 48}
    assert heads["g_s1"] == heads["human_g_s2"] == {48, 32}
    assert {mod.channels for mod in m.modules() if isinstance(mod, GDN)} == {192, 256}


def test_create_model_is_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.create_model("stf9", **TINY)


# --- the twins ---------------------------------------------------------------------

def _assert_decodes(dec, enc_y_hat, enc_x_hat):
    """A decode of another framework's streams: y_hat within CROSS_TOL of
    the encoder's (a wrong symbol shows as a jump of 1 or more), x_hat
    within the forward's bar."""
    np.testing.assert_allclose(dec[0], enc_y_hat, rtol=0, atol=CROSS_TOL)
    np.testing.assert_allclose(dec[1], enc_x_hat, rtol=0, atol=FORWARD_TOL)


class CRCTwin:
    """The eval forward, host wire and device wire of one twin; a file per
    twin subclasses it as ``Test<Name>`` with ``name`` set."""

    name = ""

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin(self.name)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, xj)
        jc = JaxCRCCodec(jm, variables)
        jdev = JaxCRCCodec(jm, variables, wire="device")
        host = CRCCodec(tm, tables=jax_tables(jc))
        dev = CRCCodec(tm, tables=jax_tables(jdev), wire="device")
        return dict(jm=jm, variables=variables, tm=tm, x=x, ref=ref,
                    jc={"host": jc, "device": jdev}, port={"host": host, "device": dev},
                    jenc={"host": jc.compress(xj, return_debug=True),
                          "device": jdev.compress(xj, return_debug=True)},
                    enc={"host": host.compress(xt, return_debug=True),
                         "device": dev.compress(xt, return_debug=True)})

    def test_state_dict_covers_every_jax_parameter(self, twin):
        assert (len(jax.tree_util.tree_leaves(twin["variables"]["params"]))
                == len(twin["tm"].state_dict()))

    def test_eval_forward_matches_jax(self, twin):
        """x_hat (and decompressedImage, the same tensor), machine_x_hat and
        the four likelihoods within 1e-4."""
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]))
        ref = twin["ref"]
        assert out["decompressedImage"] is out["x_hat"]
        pairs = [(out[k], ref[k], k) for k in ("x_hat", "machine_x_hat")]
        pairs += [(out[g][k], ref[g][k], f"{g} {k}")
                  for g in ("likelihoods", "machine_likelihoods") for k in "yz"]
        err = {name: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, name in pairs}
        print(f"{self.name} largest |port - JAX|: {err}")
        for a, b, name in pairs:
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=name)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_roundtrip_bitexact(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["port"][wire].decompress(enc["strings"], enc["shape"], enc["human_shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape
        assert float(dec["x_hat"].min()) >= 0 and float(dec["x_hat"].max()) <= 1

    def test_device_wire_floats_are_the_host_wire_floats(self, twin):
        """The wires differ in their entropy coding only: the device wire's
        y_hat and x_hat equal the host wire's bit for bit."""
        host, dev = twin["enc"]["host"], twin["enc"]["device"]
        assert torch.equal(dev["y_hat"], host["y_hat"])
        assert torch.equal(dev["x_hat"], host["x_hat"])

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_symbols_match_jax(self, twin, wire):
        """0 of the machine y symbols differ from the JAX codec's, and the
        decoder's x_hat is JAX's within the forward's bar."""
        enc, jenc = twin["enc"][wire], twin["jenc"][wire]
        port_y, jax_y = nhwc(enc["y_hat"]), np.asarray(jenc["y_hat"])
        flipped = np.abs(port_y - jax_y) > 0.5
        print(f"{self.name} {wire}: y symbols that differ from JAX's: {flipped.sum()} of "
              f"{flipped.size}")
        assert flipped.sum() == 0
        np.testing.assert_allclose(port_y, jax_y, rtol=0, atol=CROSS_TOL)
        np.testing.assert_allclose(enc["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)
        assert enc["shape"] == tuple(jenc["shape"])
        assert enc["human_shape"] == tuple(jenc["human_shape"])

    @pytest.mark.parametrize("wire", ["host", "device"])
    @pytest.mark.parametrize("stream", range(4))
    def test_streams_match_jax_byte_for_byte(self, twin, wire, stream):
        """Each of [machine_y, machine_z, human_y, human_z], image by image."""
        got, want = twin["enc"][wire]["strings"][stream], twin["jenc"][wire]["strings"][stream]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"stream {stream} of image {b}: {len(g)} vs {len(w)} bytes"

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_port_decodes_the_jax_streams(self, twin, wire):
        jenc = twin["jenc"][wire]
        dec = twin["port"][wire].decompress(jenc["strings"], jenc["shape"], jenc["human_shape"])
        _assert_decodes((nhwc(dec["y_hat"]), dec["x_hat"].numpy()),
                        np.asarray(jenc["y_hat"]), np.asarray(jenc["x_hat"]))

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_jax_decodes_the_port_streams(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["jc"][wire].decompress(enc["strings"], enc["shape"], enc["human_shape"])
        _assert_decodes((np.asarray(dec["y_hat"]), np.asarray(dec["x_hat"])),
                        nhwc(enc["y_hat"]), enc["x_hat"].numpy())


def _noise(tm, x, seed: int = 5):
    """-> the noise arrays of one training forward, in the order both
    frameworks draw them: the machine z (bottleneck layout (C, 1, n)),
    each machine slice (NHWC), the human z and the human y."""
    rng = np.random.default_rng(seed)
    B, H, W, _ = x.shape
    c = tm.coder
    zc = TINY["hyper_enc_widths"][-1]
    hb = H // 16 // c.spatial_number

    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    return ([u(zc, 1, B * (H // 64) * (W // 64))]
            + [u(B, hb, hb, c.slice_ch) for _ in range(c.ctx_slices)]
            + [u(zc, 1, B * (H // 64) * (W // 64)), u(B, H // 16, W // 16, TINY["M"])])


class CRCScanTwin:
    """The scan wire, stacked weights and training step of one twin; a file
    per twin subclasses it as ``Test<Name>Scan`` with ``name`` set."""

    name = ""

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin(self.name)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        jscan = JaxCRCCodec(jm, variables, wire="device", scan_wire=True)
        scan = CRCCodec(tm, tables=jax_tables(jscan), wire="device", scan_wire=True)
        dev = CRCCodec(tm, tables=jax_tables(jscan), wire="device")
        return dict(jm=jm, variables=variables, tm=tm, x=x, jscan=jscan, scan=scan, dev=dev,
                    jenc=jscan.compress(xj, return_debug=True),
                    enc=scan.compress(xt, return_debug=True),
                    dev_enc=dev.compress(xt, return_debug=True))

    def test_scan_wire_roundtrip_bitexact(self, twin):
        enc = twin["enc"]
        dec = twin["scan"].decompress(enc["strings"], enc["shape"], enc["human_shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert torch.equal(dec["x_hat"], enc["x_hat"])

    @pytest.mark.parametrize("stream", range(4))
    def test_scan_wire_streams_match_jax_byte_for_byte(self, twin, stream):
        """[machine_y (scan-wire framing and tier byte), machine_z, human_y,
        human_z], image by image."""
        got, want = twin["enc"]["strings"][stream], twin["jenc"]["strings"][stream]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"stream {stream} of image {b}: {len(g)} vs {len(w)} bytes"
        if stream == 0:
            assert all(g[3] == WIRE_SCAN for g in got)

    def test_scan_wire_y_hat_matches_jax(self, twin):
        np.testing.assert_allclose(nhwc(twin["enc"]["y_hat"]), np.asarray(twin["jenc"]["y_hat"]),
                                   rtol=0, atol=1e-5)

    def test_port_decodes_the_jax_scan_wire(self, twin):
        jenc = twin["jenc"]
        dec = twin["scan"].decompress(jenc["strings"], jenc["shape"], jenc["human_shape"])
        _assert_decodes((nhwc(dec["y_hat"]), dec["x_hat"].numpy()),
                        np.asarray(jenc["y_hat"]), np.asarray(jenc["x_hat"]))

    def test_jax_decodes_the_port_scan_wire(self, twin):
        enc = twin["enc"]
        dec = twin["jscan"].decompress(enc["strings"], enc["shape"], enc["human_shape"])
        _assert_decodes((np.asarray(dec["y_hat"]), np.asarray(dec["x_hat"])),
                        nhwc(enc["y_hat"]), enc["x_hat"].numpy())

    def test_scan_y_hat_against_the_device_wire(self, twin):
        """The padded first conv sums in another order than the unrolled
        one: y_hat within JAX's distribution bar (``tests/test_crc.py``:
        under 0.5% of elements more than 1e-2 apart, median under 1e-4)."""
        d = np.abs(twin["enc"]["y_hat"].numpy() - twin["dev_enc"]["y_hat"].numpy())
        print(f"{self.name}: scan vs device wire y_hat: {np.mean(d > 1e-2):.4%} past 1e-2, "
              f"median {np.median(d):.2e}")
        assert np.mean(d > 1e-2) < 0.005 and np.median(d) < 1e-4

    def test_wrong_wires_and_the_bf16_policy_raise(self, twin):
        """Device-wire streams do not decode on the scan wire; the scan wire
        takes float32 only; a scan wire needs the device wire."""
        enc = twin["dev_enc"]
        with pytest.raises(WireFormatError):
            twin["scan"].decompress(enc["strings"], enc["shape"], enc["human_shape"])
        with pytest.raises(ValueError, match="wire='device'"):
            CRCCodec(twin["tm"], scan_wire=True)
        try:
            tnn.set_activation_dtype(torch.bfloat16)
            with pytest.raises(ValueError, match="float32"):
                CRCCodec(twin["tm"], wire="device", scan_wire=True)
            with pytest.raises(ValueError, match="float32"):
                twin["scan"].compress(torch.from_numpy(twin["x"]))
        finally:
            tnn.set_activation_dtype(None)

    def test_stack_zigzag_params_matches_jax(self, twin):
        """The stacked, padded context weights of the machine coder bit for
        bit with JAX's ``stack_zigzag_params`` (no LRP), from the JAX tree and
        from the port's own state dict; unstacked again, the tree itself."""
        coder_tree = jax.device_get(twin["variables"]["params"]["machine"]["coder"])
        c = twin["tm"].coder
        want = jax_stack(coder_tree, c.ctx_slices, c.slice_ch, c.max_support, c.cond_width,
                         apply_lrp=False)["zz_scan"]
        got = stack_zigzag_params(coder_tree, c)["zz_scan"]
        port = stack_zigzag_params(c, c)["zz_scan"]
        assert set(got) == set(want) == set(port) == {"cc_mean", "cc_scale"}
        for tag in want:
            for ln, p in want[tag].items():
                k = np.asarray(p["kernel"])
                np.testing.assert_array_equal(got[tag][ln]["kernel"].numpy(), k)
                np.testing.assert_array_equal(port[tag][ln]["weight"].numpy(),
                                              np.transpose(k, (0, 4, 3, 1, 2)))
                np.testing.assert_array_equal(port[tag][ln]["bias"].numpy(), p["bias"])
        back = unstack_zigzag_params({"zz_scan": port}, c)
        sd = c.state_dict()
        for name, layers in back.items():
            for ln, leaves in layers.items():
                for leaf, v in leaves.items():
                    assert torch.equal(v, sd[f"{name}.{ln}.{leaf}"]), (name, ln, leaf)

    def test_from_jax_params_takes_a_zz_scan_tree(self, twin):
        """The tree of a JAX model whose coder scans (its structure from
        ``jax.eval_shape``) converts, given the model, to the state dict of
        the unrolled tree it was stacked from."""
        params = jax.device_get(twin["variables"]["params"])
        c = twin["tm"].coder
        coder = dict(params["machine"]["coder"])
        scanned_coder = {k: v for k, v in coder.items()
                         if k.rsplit("_", 1)[0] not in ("cc_mean", "cc_scale")}
        scanned_coder.update(jax_stack(coder, c.ctx_slices, c.slice_ch, c.max_support,
                                       c.cond_width, apply_lrp=False))
        scanned = {**params, "machine": {**params["machine"], "coder": scanned_coder}}
        jcls, jkw = jax_models[self.name]
        real = jax.eval_shape(lambda: jcls(**{**jkw, **TINY}, scan_charm=True).init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
            jnp.asarray(twin["x"]), training=False))["params"]
        assert (jax.tree_util.tree_map(np.shape, dict(real))
                == jax.tree_util.tree_map(np.shape, scanned))
        got, want = from_jax_params(scanned, model=twin["tm"]), from_jax_params(params)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        with pytest.raises(ValueError, match="model"):
            from_jax_params(scanned)

    def test_train_step_matches_jax(self, twin, monkeypatch):
        """One training step, the port and JAX both in float64 (as the zigzag
        family's steps, ``test_torch_stf_family_paths.py``), the same noise
        in both: RateDistortionLoss over both layers' likelihoods
        (``likelihood_keys=("likelihoods", "machine_likelihoods")``, the JAX
        model's docstring for training from scratch) and the aux loss of
        both bottlenecks; loss terms within 1e-5, every gradient within
        1e-4 of its max. The split decoder ``g_s1``/``g_s2`` (machine_x_hat)
        enters no term: no gradient in the port, zero in JAX."""
        x = twin["x"]
        keys = ("likelihoods", "machine_likelihoods")
        jm, tm = twin["jm"], make_twin(self.name)[2].double()
        noise = [a.astype(np.float64) for a in _noise(tm, x)]
        tr, jr = _replay(monkeypatch, noise)
        tr.noise = noise
        x64 = x.astype(np.float64)
        key = jax.random.PRNGKey(0)

        def loss_fn(p):
            out = jm.apply({"params": p}, jnp.asarray(x64), training=True,
                           rngs={"noise": key})
            rd = JaxRD(0.01, likelihood_keys=keys)(out, jnp.asarray(x64))
            aux = jm.apply({"params": p}, method=jm.aux_loss)
            return rd["loss"] + aux, {**rd, "aux_loss": aux}

        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                         jax.device_get(twin["variables"]["params"]))
            (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
            ref_m, ref_g = jax.device_get((ref_m, ref_g))
        assert {np.asarray(g).dtype for g in jax.tree_util.tree_leaves(ref_g)} == {
            np.dtype(np.float64)}
        assert jr.i == len(noise)

        tm.train()
        out = tm(torch.from_numpy(x64), generator=torch.Generator())
        assert out["x_hat"].dtype == torch.float64
        rd = ttrain.RateDistortionLoss(0.01, likelihood_keys=keys)(out, torch.from_numpy(x64))
        aux = tm.aux_loss()
        (rd["loss"] + aux).backward()
        assert tr.i == len(noise)
        for k, v in {**rd, "aux_loss": aux}.items():
            _close(v.item(), ref_m[k], TERMS_TOL, k)
        ref_grads = _f64_port_params(ref_g, tm)
        assert set(ref_grads) == {n for n, _ in tm.named_parameters()}
        # machine_x_hat enters no loss term: the split decoder gets no
        # gradient in the port and a zero one in JAX
        idle = {name for name, p in tm.named_parameters() if p.grad is None}
        assert idle == {name for name in ref_grads if name.startswith(("g_s1.", "g_s2."))}
        assert not any(np.any(ref_grads[name]) for name in idle)
        worst = {name: _close(p.grad.numpy(), ref_grads[name], GRAD_TOL, name)
                 for name, p in tm.named_parameters() if name not in idle}
        print(f"{self.name}: largest gradient error relative to its max:",
              max(worst.items(), key=lambda kv: kv[1]))
