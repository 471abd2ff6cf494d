"""The CRC family ``stf9`` / ``stf11``, ``stf12`` and ``stf14``:
icm_tpu_torch against the JAX package.

Narrow twins at ``tests/test_crc.py``'s ``TINY`` (N 16, M 24, mid 32, 2 x
2x2 zigzag = 8 slices, sliding support 4, a conditioning window of all 8
blocks, 2-conv context stacks) on two 64 x 64 images. The JAX twin's
parameters are drawn with numpy at the shapes of its init
(``jax.eval_shape``), GDN's and the bottlenecks' near their own inits,
and carried over with ``from_jax_params``. Each twin's tests run in files
of their own, so that the suite's workers run them side by side:

- ``test_torch_crc_stf{9,12,14}.py`` (:class:`CRCTwin`): the eval forward
  (x_hat, machine_x_hat and all four likelihoods within 1e-4), the host
  wire's four streams byte for byte with JAX's ``CRCCodec`` and its y
  symbols identical, the device wire's blobs byte for byte with JAX's
  ``CRCCodec(wire="device")`` and its y_hat equal to the host wire's,
  decoding across the two frameworks both ways on both wires;
- ``test_torch_crc_scan_stf{9,12,14}.py`` (:class:`CRCScanTwin`): the
  scan wire's blobs byte for byte with JAX's ``CRCCodec(scan_wire=True)``
  (tier byte included), its round trip, cross decoding, y_hat against the
  device wire's within JAX's distribution bar (``tests/test_crc.py``),
  the stacked context weights against JAX's ``stack_zigzag_params`` and
  ``from_jax_params`` of a ``zz_scan`` tree, and one training step of
  each JAX forward (the unrolled one, and ``scan_charm=True``: its
  ``code_scan`` over the stacked tree) against the port's one forward
  through JAX autodiff, both in
  float64, the noise replayed into both: loss terms within 1e-5, every
  gradient within 1e-4 of its max;
- ``test_torch_crc_bf16_stf{9,12,14}.py`` (:class:`CRCBf16Twin`): the
  bfloat16 policy's eval forward and training step (both forwards) and
  both wires against JAX's bfloat16 models, at ``tests/test_bf16.py``'s
  bars.

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
from test_torch_bf16 import (BF16, BPP_RTOL, SYMBOL_SHARE_TOL, XHAT_MEAN_TOL,
                             _assert_bf16_close, _bpp)
from test_torch_cnn_codec import CROSS_TOL
from test_torch_stf_family import on_wires, port_tables
from test_torch_stf_family_paths import GRAD_TOL, TERMS_TOL, _f64_port_params
from test_torch_train import _close, _replay

from icm_tpu import nn as jnn
from icm_tpu.entropy import EntropyBottleneck
from icm_tpu.models import models as jax_models
from icm_tpu.models.crc_codec import CRC3Codec as JaxCRC3Codec
from icm_tpu.models.crc_codec import CRCCodec as JaxCRCCodec
from icm_tpu.models.zigzag_coder import stack_zigzag_params as jax_stack
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.coding import WireFormatError
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.crc import (ConditionalResidualCoding, ConditionalResidualCoding2,
                                     ConditionalResidualCoding3, ResidualCoding)
from icm_tpu_torch.models.crc_codec import CRC3Codec, CRCCodec
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
    _put_bottlenecks(params, shapes, seed, lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32))
    return {"params": jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)}


def _put_bottlenecks(tree: dict, shapes: dict, seed: int, perturb=np.asarray) -> None:
    """Put each entropy bottleneck of ``shapes`` into ``tree``: its own JAX
    init, each array passed through ``perturb``."""
    for k, v in shapes.items():
        if k.startswith("entropy_bottleneck"):
            C = v["quantiles"].shape[0]
            eb = EntropyBottleneck(C).init(
                {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(seed)},
                jnp.zeros((1, 2, 2, C)), training=False)["params"]
            tree[k] = jax.tree_util.tree_map(perturb, jax.device_get(eb))
        elif isinstance(v, dict):
            _put_bottlenecks(tree[k], v, seed, perturb)


def _truncated_normal(rng, shape) -> np.ndarray:
    """Standard normal draws truncated to [-2, 2], as flax's truncated
    normal initializers draw them before scaling."""
    n = rng.standard_normal(shape, dtype=np.float32)
    while (out := np.abs(n) > 2).any():
        n[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
    return n


def init_like(tree: dict, seed: int = 3) -> dict:
    """Variables of the structure and shapes of ``tree`` (arrays, or a
    ``jax.eval_shape`` tree) drawn with numpy from the JAX init's
    distributions, where tracing and compiling the JAX init itself costs up
    to a minute a twin: convolution kernels and the masked context models'
    dense kernels (flax's ``nn.Dense``) LeCun-normal (truncated, variance
    1/fan-in, flax's default), the other dense kernels (the transforms'
    attention and MLPs, ``icm_tpu.nn.layers._trunc_dense``) and the
    relative-position tables truncated normal at 0.02, biases 0, LayerNorm,
    GDN and BatchNorm at their inits, each bottleneck its own JAX init."""
    rng = np.random.default_rng(seed)
    pedestal = 2.0 ** -36

    def draw(path, leaf):
        keys = [getattr(p, "key", "") for p in path]
        parent, name = keys[-2], keys[-1]
        if any(k.startswith("entropy_bottleneck") for k in keys):
            return None  # below
        if parent.startswith("GDN"):
            if name == "beta":
                return np.full(leaf.shape, np.sqrt(1.0 + pedestal), np.float32)
            return np.sqrt(0.1 * np.eye(leaf.shape[0], dtype=np.float32) + pedestal)
        if name == "kernel" and (len(leaf.shape) > 2
                                 or any(k.endswith("ContextModel") for k in keys)):
            # flax's variance_scaling: the truncated draw's std corrected to 1
            return _truncated_normal(rng, leaf.shape) / np.float32(
                0.87962566 * np.sqrt(np.prod(leaf.shape[:-1])))
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        if name in ("bias", "mean"):
            return np.zeros(leaf.shape, np.float32)
        return 0.02 * _truncated_normal(rng, leaf.shape)  # dense kernels, tables

    out = jax.tree_util.tree_map_with_path(draw, tree)
    _put_bottlenecks(out, tree, seed)
    return out


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
FULL_WIDTH_PARAMS = {"stf9": 339_633_593, "stf11": 339_633_593, "stf12": 363_781_457,
                     "stf13": 801_809_431, "stf14": 331_138_553}
CLASSES = {"stf9": ConditionalResidualCoding, "stf11": ConditionalResidualCoding,
           "stf12": ConditionalResidualCoding2, "stf13": ConditionalResidualCoding3,
           "stf14": ResidualCoding}


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_registry_builds_the_published_widths(name):
    """The port's registry holds the JAX package's class for each name at its
    defaults (stf11 is stf9's class): built on the meta device, each has
    the JAX model's parameter count, 24 zigzag slices of 64 channels and
    a conditioning window of 24 blocks in each coder, and LRP stacks in
    stf13's two coders (3-conv context stacks) and no other's."""
    cls, kwargs = tmodels.models[name]
    jcls, jkwargs = jax_models[name]
    assert cls is CLASSES[name] and cls.__name__ == jcls.__name__ and kwargs == jkwargs == {}
    with torch.device("meta"):
        m = cls()
    assert sum(p.numel() for p in m.parameters()) == FULL_WIDTH_PARAMS[name]
    coders = [m.coder] + ([m.seg_coder] if name == "stf13" else [])
    for c in coders:
        assert (c.ctx_slices, c.slice_ch, c.max_support, c.cond_blocks) == (24, 64, 12, 24)
        lrp = [n for n, _ in c.named_children() if n.startswith("lrp_")]
        assert c.apply_lrp == (name == "stf13") and len(lrp) == (24 if c.apply_lrp else 0)
        convs = [n for n, _ in c.cc_mean_0.named_children() if n.startswith("Conv_")]
        assert len(convs) == (3 if name == "stf13" else 5)
    assert hasattr(m, "human_context_decoder") == (name != "stf14")


def test_stf11_is_stf9():
    assert tmodels.models["stf11"][0] is tmodels.models["stf9"][0]


@pytest.mark.parametrize("name", ["stf9", "stf12", "stf13", "stf14"])
def test_attention_and_gdn_widths_on_the_path(name):
    """The published widths put window attention at head widths 24 (g_a's
    first block), 48 (every 384-channel block) and 32 (the decoders'
    256-channel block), stf12's decoder head at 96 (768 channels), and GDN
    at 192 and 256 channels, on the path; each width is one the kernel is
    built for. stf13: its five MainCNNDecoders (g_s, seg_g_s and three
    conditioning decoders) at 48 and 32, its three ContextScale2 and
    seg_g_a2 at 48."""
    from icm_tpu_torch.nn import GDN, WinBasedAttention
    from icm_tpu_torch.nn.window_attention import SUPPORTED_HEAD_DIMS

    with torch.device("meta"):
        m = tmodels.models[name][0]()
    heads = {n.split(".")[0]: set() for n, _ in m.named_modules()}
    for n, mod in m.named_modules():
        if isinstance(mod, WinBasedAttention):
            heads[n.split(".")[0]].add(mod.attn.dim // mod.attn.num_heads)
    assert heads["machine"] == {24, 48}
    if name == "stf13":
        assert all(heads[k] == {48, 32} for k in ("g_s", "seg_g_enc2", "seg_g_s",
                                                   "human_g_enc2", "human_g_enc4"))
        assert all(heads[k] == {48} for k in ("seg_g_enc3", "seg_g_a2", "human_g_enc3",
                                               "human_g_enc5"))
        assert not heads["human_g_a2_2"] and "g_s1" not in heads
    else:
        assert heads["g_s1"] == {48, 32}
    if name == "stf12":
        assert heads["human_g_enc2"] == {48, 32}
        assert heads["human_g_enc3"] == heads["human_g_a2"] == {48}
        assert heads["human_g_s1"] == {96}
    elif name != "stf13":
        assert heads["human_g_s2"] == {48, 32}
    assert set().union(*heads.values()) <= set(SUPPORTED_HEAD_DIMS)
    assert {mod.channels for mod in m.modules() if isinstance(mod, GDN)} == {192, 256}


def test_create_model_is_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.create_model("stf9", **TINY)


# --- the twins ---------------------------------------------------------------------

class _Layout:
    """What a twin's codec gives, by model: the four-stream CRC codecs, and
    (:class:`CRC3Layout`) stf13's six streams."""

    jax_codec = JaxCRCCodec
    codec = CRCCodec
    n_streams = 4
    shape_keys = ("shape",)
    latent_keys = ("y_hat",)  # the zigzag layers' latents, in stream order
    image_keys = ("x_hat", "machine_x_hat")
    keys = ("likelihoods", "machine_likelihoods")
    fixed = ("g_s1.", "g_s2.")  # the decoders no loss term reads
    coder_paths = (("machine", "coder"),)

    def decompress(self, codec, enc):
        return codec.decompress(enc["strings"], *[enc[k] for k in self.shape_keys],
                                enc["human_shape"])

    def decodes(self, dec, enc, jax_side: bool):
        """A decode of another framework's streams (``jax_side``: the JAX
        codec decoded the port's): each latent within CROSS_TOL of the
        encoder's (a wrong symbol shows as a jump of 1 or more), x_hat
        within the forward's bar."""
        for k in self.latent_keys:
            got = np.asarray(dec[k]) if jax_side else nhwc(dec[k])
            want = nhwc(enc[k]) if jax_side else np.asarray(enc[k])
            np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_TOL, err_msg=k)
        np.testing.assert_allclose(np.asarray(dec["x_hat"]), np.asarray(enc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)


class CRC3Layout(_Layout):
    jax_codec = JaxCRC3Codec
    codec = CRC3Codec
    n_streams = 6
    shape_keys = ("shape", "seg_shape")
    latent_keys = ("y_hat", "seg_y_hat")
    image_keys = ("x_hat", "machine_x_hat", "seg_x_hat")
    keys = ("likelihoods", "machine_likelihoods", "seg_likelihoods")
    fixed = ("g_s.", "seg_g_s.")
    coder_paths = (("machine", "coder"), ("seg_coder",))


class CRCTwin(_Layout):
    """The eval forward, host wire and device wire of one twin; a file per
    twin subclasses it as ``Test<Name>`` with ``name`` set."""

    name = ""

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin(self.name)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, xj)
        # one JAX codec serves both wires, which share its compiled functions
        jc = on_wires(self.jax_codec(jm, variables, wire="device"))
        host = self.codec(tm, tables=jax_tables(jc["host"]))
        dev = self.codec(tm, tables=jax_tables(jc["device"]), wire="device")
        return dict(jm=jm, variables=variables, tm=tm, x=x, ref=ref,
                    jc=jc, port={"host": host, "device": dev},
                    jenc={w: c.compress(xj, return_debug=True) for w, c in jc.items()},
                    enc={"host": host.compress(xt, return_debug=True),
                         "device": dev.compress(xt, return_debug=True)})

    def test_state_dict_covers_every_jax_parameter(self, twin):
        assert (len(jax.tree_util.tree_leaves(twin["variables"]["params"]))
                == len(twin["tm"].state_dict()))

    def test_eval_forward_matches_jax(self, twin):
        """x_hat (and decompressedImage, the same tensor), machine_x_hat
        (stf13: seg_x_hat) and the four (six) likelihoods within 1e-4."""
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]))
        ref = twin["ref"]
        assert out["decompressedImage"] is out["x_hat"]
        assert set(out) == set(ref)
        pairs = [(out[k], ref[k], k) for k in self.image_keys]
        pairs += [(out[g][k], ref[g][k], f"{g} {k}") for g in self.keys for k in "yz"]
        err = {name: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, name in pairs}
        print(f"{self.name} largest |port - JAX|: {err}")
        for a, b, name in pairs:
            assert a.shape == b.shape, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=name)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_roundtrip_bitexact(self, twin, wire):
        enc = twin["enc"][wire]
        dec = self.decompress(twin["port"][wire], enc)
        for k in self.latent_keys:
            assert torch.equal(dec[k], enc[k]), k
        assert torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape
        assert float(dec["x_hat"].min()) >= 0 and float(dec["x_hat"].max()) <= 1

    def test_device_wire_floats_are_the_host_wire_floats(self, twin):
        """The wires differ in their entropy coding only: the device wire's
        y_hat (stf13: and seg_y_hat) and x_hat equal the host wire's bit
        for bit."""
        host, dev = twin["enc"]["host"], twin["enc"]["device"]
        for k in self.latent_keys + ("x_hat",):
            assert torch.equal(dev[k], host[k]), k

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_symbols_match_jax(self, twin, wire):
        """0 of the machine (stf13: and segmentation) y symbols differ from
        the JAX codec's, and the decoder's x_hat is JAX's within the
        forward's bar."""
        enc, jenc = twin["enc"][wire], twin["jenc"][wire]
        for k in self.latent_keys:
            port_y, jax_y = nhwc(enc[k]), np.asarray(jenc[k])
            flipped = np.abs(port_y - jax_y) > 0.5
            print(f"{self.name} {wire}: {k} symbols that differ from JAX's: {flipped.sum()} of "
                  f"{flipped.size}")
            assert flipped.sum() == 0
            np.testing.assert_allclose(port_y, jax_y, rtol=0, atol=CROSS_TOL)
        np.testing.assert_allclose(enc["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)
        for k in self.shape_keys + ("human_shape",):
            assert enc[k] == tuple(jenc[k]), k

    def _assert_stream(self, twin, wire, stream):
        got, want = twin["enc"][wire]["strings"][stream], twin["jenc"][wire]["strings"][stream]
        assert len(twin["enc"][wire]["strings"]) == self.n_streams
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"stream {stream} of image {b}: {len(g)} vs {len(w)} bytes"

    @pytest.mark.parametrize("wire", ["host", "device"])
    @pytest.mark.parametrize("stream", range(4))
    def test_streams_match_jax_byte_for_byte(self, twin, wire, stream):
        """Each of [machine_y, machine_z, human_y, human_z], image by image."""
        self._assert_stream(twin, wire, stream)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_port_decodes_the_jax_streams(self, twin, wire):
        jenc = twin["jenc"][wire]
        self.decodes(self.decompress(twin["port"][wire], jenc), jenc, jax_side=False)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_jax_decodes_the_port_streams(self, twin, wire):
        enc = twin["enc"][wire]
        self.decodes(self.decompress(twin["jc"][wire], enc), enc, jax_side=True)


class CRC3Twin(CRC3Layout, CRCTwin):
    """stf13's :class:`CRCTwin`: six streams, both zigzag layers' symbols
    and latents."""

    @pytest.mark.parametrize("wire", ["host", "device"])
    @pytest.mark.parametrize("stream", range(6))
    def test_streams_match_jax_byte_for_byte(self, twin, wire, stream):
        """Each of [machine_y, machine_z, seg_y, seg_z, human_y, human_z],
        image by image."""
        self._assert_stream(twin, wire, stream)


def _coders(tm, coder_paths) -> list:
    return [tm.get_submodule(".".join(path)) for path in coder_paths]


def _noise(tm, x, scan: bool = False, seed: int = 5, coder_paths=(("machine", "coder"),)):
    """-> (JAX's noise arrays, the port's) of one training forward, in the
    order both frameworks draw them: for each zigzag layer (the machine's;
    stf13's segmentation layer's after it) its z (bottleneck layout (C, 1,
    n)) and each slice (NHWC), then the human z and the human y. JAX's
    ``scan_charm=True`` forward traces each scan step twice (once to build
    it), so one array stands for every slice of a layer there, and the
    port is handed that array for each slice."""
    rng = np.random.default_rng(seed)
    B, H, W, _ = x.shape
    zc = TINY["hyper_enc_widths"][-1]
    n_z = B * (H // 64) * (W // 64)

    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)

    z = u(zc, 1, n_z)
    human = [u(zc, 1, n_z), u(B, H // 16, W // 16, TINY["M"])]
    jax_noise, port_noise = [], []
    for k, c in enumerate(_coders(tm, coder_paths)):
        hb = H // 16 // c.spatial_number
        zk = z if k == 0 else u(zc, 1, n_z)
        if scan:
            s = u(B, hb, hb, c.slice_ch)
            jax_noise += [zk, s, s]
            port_noise += [zk] + [s] * c.ctx_slices
        else:
            ys = [u(B, hb, hb, c.slice_ch) for _ in range(c.ctx_slices)]
            jax_noise += [zk] + ys
            port_noise += [zk] + ys
    return jax_noise + human, port_noise + human


def _at(tree: dict, path) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def _with(tree: dict, path, value) -> dict:
    """``tree`` with the subtree at ``path`` replaced (the rest shared)."""
    if not path:
        return value
    return {**tree, path[0]: _with(tree[path[0]], path[1:], value)}


def _scanned_tree(params: dict, tm, coder_paths=(("machine", "coder"),)) -> dict:
    """A JAX parameter tree with each zigzag coder's context stacks stacked
    into its ``zz_scan`` subtree (``lrp`` too where the coder applies
    LRP), as a ``scan_charm=True`` model holds them."""
    for path, coder in zip(coder_paths, _coders(tm, coder_paths)):
        c = dict(_at(params, path))
        scanned = {k: v for k, v in c.items() if k.rsplit("_", 1)[0] not in coder.tags}
        scanned.update(jax_stack(c, coder.ctx_slices, coder.slice_ch, coder.max_support,
                                 coder.cond_width, apply_lrp=coder.apply_lrp))
        params = _with(params, path, scanned)
    return params


def _unscanned_tree(tree: dict, tm, coder_paths=(("machine", "coder"),)) -> dict:
    """The inverse of :func:`_scanned_tree` on a float64 tree (the port's
    ``unstack_zigzag_params`` keeps the dtype)."""
    for path, coder in zip(coder_paths, _coders(tm, coder_paths)):
        c = dict(_at(tree, path))
        slices = unstack_zigzag_params({"zz_scan": c.pop("zz_scan")}, coder)
        c.update({k: {ln: {leaf: t.numpy() for leaf, t in p.items()} for ln, p in layers.items()}
                  for k, layers in slices.items()})
        tree = _with(tree, path, c)
    return tree


class CRCScanTwin(_Layout):
    """The scan wire, stacked weights and training step of one twin; a file
    per twin subclasses it as ``Test<Name>Scan`` with ``name`` set."""

    name = ""

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin(self.name)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        jscan = self.jax_codec(jm, variables, wire="device", scan_wire=True)
        scan = self.codec(tm, tables=jax_tables(jscan), wire="device", scan_wire=True)
        dev = self.codec(tm, tables=jax_tables(jscan), wire="device")
        return dict(jm=jm, variables=variables, tm=tm, x=x, jscan=jscan, scan=scan, dev=dev,
                    jenc=jscan.compress(xj, return_debug=True),
                    enc=scan.compress(xt, return_debug=True),
                    dev_enc=dev.compress(xt, return_debug=True))

    def test_scan_wire_roundtrip_bitexact(self, twin):
        enc = twin["enc"]
        dec = self.decompress(twin["scan"], enc)
        for k in self.latent_keys:
            assert torch.equal(dec[k], enc[k]), k
        assert torch.equal(dec["x_hat"], enc["x_hat"])

    def _assert_scan_stream(self, twin, stream):
        got, want = twin["enc"]["strings"][stream], twin["jenc"]["strings"][stream]
        assert len(twin["enc"]["strings"]) == self.n_streams
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"stream {stream} of image {b}: {len(g)} vs {len(w)} bytes"
        if stream < 2 * len(self.latent_keys) and stream % 2 == 0:  # a zigzag layer's y
            assert all(g[3] == WIRE_SCAN for g in got)

    @pytest.mark.parametrize("stream", range(4))
    def test_scan_wire_streams_match_jax_byte_for_byte(self, twin, stream):
        """[machine_y (scan-wire framing and tier byte), machine_z, human_y,
        human_z], image by image."""
        self._assert_scan_stream(twin, stream)

    def test_scan_wire_y_hat_matches_jax(self, twin):
        for k in self.latent_keys:
            np.testing.assert_allclose(nhwc(twin["enc"][k]), np.asarray(twin["jenc"][k]),
                                       rtol=0, atol=1e-5, err_msg=k)

    def test_port_decodes_the_jax_scan_wire(self, twin):
        jenc = twin["jenc"]
        self.decodes(self.decompress(twin["scan"], jenc), jenc, jax_side=False)

    def test_jax_decodes_the_port_scan_wire(self, twin):
        enc = twin["enc"]
        self.decodes(self.decompress(twin["jscan"], enc), enc, jax_side=True)

    def test_scan_y_hat_against_the_device_wire(self, twin):
        """The padded first conv sums in another order than the unrolled
        one: y_hat (stf13: and seg_y_hat) within JAX's distribution bar
        (``tests/test_crc.py``: under 0.5% of elements more than 1e-2
        apart, median under 1e-4)."""
        for k in self.latent_keys:
            d = np.abs(twin["enc"][k].numpy() - twin["dev_enc"][k].numpy())
            print(f"{self.name}: scan vs device wire {k}: {np.mean(d > 1e-2):.4%} past 1e-2, "
                  f"median {np.median(d):.2e}")
            assert np.mean(d > 1e-2) < 0.005 and np.median(d) < 1e-4, k

    def test_wrong_wires_and_the_bf16_policy_raise(self, twin):
        """Device-wire streams do not decode on the scan wire; the scan wire
        takes float32 only; a scan wire needs the device wire."""
        enc = twin["dev_enc"]
        with pytest.raises(WireFormatError):
            self.decompress(twin["scan"], enc)
        with pytest.raises(ValueError, match="wire='device'"):
            self.codec(twin["tm"], scan_wire=True)
        try:
            tnn.set_activation_dtype(torch.bfloat16)
            with pytest.raises(ValueError, match="float32"):
                self.codec(twin["tm"], wire="device", scan_wire=True)
            with pytest.raises(ValueError, match="float32"):
                twin["scan"].compress(torch.from_numpy(twin["x"]))
        finally:
            tnn.set_activation_dtype(None)

    def test_stack_zigzag_params_matches_jax(self, twin):
        """The stacked, padded context weights of the machine coder (stf13:
        and the segmentation coder, both with their ``lrp`` slot; the
        others' no LRP) bit for bit with JAX's ``stack_zigzag_params``,
        from the JAX tree and from the port's own state dict; unstacked
        again, the tree itself."""
        params = jax.device_get(twin["variables"]["params"])
        for path, c in zip(self.coder_paths, _coders(twin["tm"], self.coder_paths)):
            coder_tree = _at(params, path)
            want = jax_stack(coder_tree, c.ctx_slices, c.slice_ch, c.max_support, c.cond_width,
                             apply_lrp=c.apply_lrp)["zz_scan"]
            got = stack_zigzag_params(coder_tree, c)["zz_scan"]
            port = stack_zigzag_params(c, c)["zz_scan"]
            assert set(got) == set(want) == set(port) == set(c.tags)
            assert c.apply_lrp == (self.name == "stf13")
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
        scanned = _scanned_tree(params, twin["tm"], self.coder_paths)
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

    @pytest.mark.parametrize("forward", ["unrolled", "scan_charm"])
    def test_train_step_matches_jax(self, twin, forward, monkeypatch):
        """One training step of JAX's forward (the registry's unrolled one,
        or ``scan_charm=True``: its ``code_scan`` over the stacked tree)
        against the port's registry model, which serves both, the two in
        float64 (as the zigzag family's steps,
        ``test_torch_stf_family_paths.py``), the same noise in both:
        RateDistortionLoss over every layer's likelihoods
        (``likelihood_keys=("likelihoods", "machine_likelihoods")``, stf13
        with ``"seg_likelihoods"``, the JAX model's docstring for training
        from scratch) and the aux loss of every bottleneck; loss terms
        within 1e-5, every gradient within 1e-4 of its max, JAX's
        ``zz_scan`` gradients unstacked. The split decoder ``g_s1``/``g_s2``
        (machine_x_hat; stf13's ``g_s`` and ``seg_g_s``, seg_x_hat too)
        enters no term: no gradient in the port, zero in JAX."""
        scan = forward == "scan_charm"
        x = twin["x"]
        keys = self.keys
        params = jax.device_get(twin["variables"]["params"])
        jm = twin["jm"]
        tm = tmodels.create_model(self.name, device="cpu", **TINY)  # the twin's weights
        tm.load_state_dict(twin["tm"].state_dict())
        if scan:
            jcls, jkw = jax_models[self.name]
            jm = jcls(**{**jkw, **TINY}, scan_charm=True)
            params = _scanned_tree(params, tm, self.coder_paths)
        tm = tm.double()
        jax_noise, port_noise = _noise(tm, x, scan, coder_paths=self.coder_paths)
        tr, jr = _replay(monkeypatch, [a.astype(np.float64) for a in jax_noise])
        tr.noise = [a.astype(np.float64) for a in port_noise]
        x64 = x.astype(np.float64)
        key = jax.random.PRNGKey(0)

        def loss_fn(p):
            out = jm.apply({"params": p}, jnp.asarray(x64), training=True,
                           rngs={"noise": key})
            rd = JaxRD(0.01, likelihood_keys=keys)(out, jnp.asarray(x64))
            aux = jm.apply({"params": p}, method=jm.aux_loss)
            return rd["loss"] + aux, {**rd, "aux_loss": aux}

        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
            (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
            ref_m, ref_g = jax.device_get((ref_m, ref_g))
        assert {np.asarray(g).dtype for g in jax.tree_util.tree_leaves(ref_g)} == {
            np.dtype(np.float64)}
        assert jr.i == len(jax_noise)

        tm.train()
        out = tm(torch.from_numpy(x64), generator=torch.Generator())
        assert out["x_hat"].dtype == torch.float64
        rd = ttrain.RateDistortionLoss(0.01, likelihood_keys=keys)(out, torch.from_numpy(x64))
        aux = tm.aux_loss()
        (rd["loss"] + aux).backward()
        assert tr.i == len(port_noise)
        for k, v in {**rd, "aux_loss": aux}.items():
            _close(v.item(), ref_m[k], TERMS_TOL, k)
        ref_grads = _f64_port_params(
            _unscanned_tree(ref_g, tm, self.coder_paths) if scan else ref_g, tm)
        assert set(ref_grads) == {n for n, _ in tm.named_parameters()}
        # machine_x_hat (seg_x_hat) enters no loss term: its decoder gets no
        # gradient in the port and a zero one in JAX
        idle = {name for name, p in tm.named_parameters() if p.grad is None}
        assert idle == {name for name in ref_grads if name.startswith(self.fixed)}
        assert not any(np.any(ref_grads[name]) for name in idle)
        worst = {name: _close(p.grad.numpy(), ref_grads[name], GRAD_TOL, name)
                 for name, p in tm.named_parameters() if name not in idle}
        print(f"{self.name} {forward}: largest gradient error relative to its max:",
              max(worst.items(), key=lambda kv: kv[1]))


class CRC3ScanTwin(CRC3Layout, CRCScanTwin):
    """stf13's :class:`CRCScanTwin`: both zigzag layers on the scan wire,
    six streams."""

    @pytest.mark.parametrize("stream", range(6))
    def test_scan_wire_streams_match_jax_byte_for_byte(self, twin, stream):
        """[machine_y, machine_z, seg_y, seg_z (each y with the scan-wire
        framing and tier byte), human_y, human_z], image by image."""
        self._assert_scan_stream(twin, stream)


class CRCBf16Twin(_Layout):
    """The bfloat16 policy's tests of one twin, against JAX's model and
    ``CRCCodec`` under ``set_activation_dtype(jnp.bfloat16)``, at
    ``tests/test_bf16.py``'s bars (``test_torch_bf16.py``); a file per twin
    subclasses it as ``Test<Name>Bf16`` with ``name`` set.

    The twins take weights of the JAX init's distributions
    (:func:`init_like`; ``tests/test_bf16.py``'s bars were set at the
    init), drawn with numpy where JAX's own init takes 45-70 s a twin to
    trace and compile. With the float32 twins' draws (``_draw_params``:
    GDN perturbed, transposed convs at twice the fan-in scale) JAX's own
    bfloat16 forward strays from its float32 one by 0.036 of mean |x_hat|
    (stf12; stf14 0.014, machine_x_hat 0.053), past the bar; at the init's
    distributions the port's bfloat16 forward strays from its float32 one
    by 3e-4 (stf13's x_hat) to 3e-3 (its machine_x_hat) on the CPU. stf9's
    human x_hat is near zero at the init, so the machine layer's
    machine_x_hat is held beside it."""

    name = ""

    @pytest.fixture(autouse=True)
    def _reset_policies(self):
        yield
        jnn.set_activation_dtype(None)
        tnn.set_activation_dtype(None)

    @pytest.fixture(scope="class")
    def twin(self):
        x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)  # make_twin's
        jcls, jkw = jax_models[self.name]
        jm = jcls(**{**jkw, **TINY})
        tm = tmodels.create_model(self.name, device="cpu", **TINY)
        params = init_like(jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)},
            jnp.asarray(x), training=False))["params"], seed=1)
        tm.load_state_dict(from_jax_params(params), strict=True)
        return dict(jm=jm, params=params, tm=tm.eval(), x=x)

    def _models(self, twin, scan: bool):
        """-> (JAX model of the forward, its params, a new port model with
        the twin's weights: the port's one forward serves both JAX's)."""
        tm = tmodels.create_model(self.name, device="cpu", **TINY)
        tm.load_state_dict(twin["tm"].state_dict())
        if not scan:
            return twin["jm"], twin["params"], tm.eval()
        jcls, jkw = jax_models[self.name]
        return (jcls(**{**jkw, **TINY}, scan_charm=True),
                _scanned_tree(twin["params"], tm, self.coder_paths), tm.eval())

    def _bpp(self, out, n_px) -> float:
        return sum(_bpp({k: np.asarray(v, np.float32) for k, v in out[g].items()}, n_px)
                   for g in self.keys)

    @pytest.mark.parametrize("forward", ["unrolled", "scan_charm"])
    def test_eval_forward_bf16_matches_jax_bf16(self, twin, forward):
        """x_hat in JAX's dtype (bfloat16 from the last transposed conv,
        float32 where stf14's training forward adds the float32 residual)
        and both layers' bpp against JAX's bfloat16 forward and the port's
        float32 one; every likelihood float32."""
        jm, params, tm = self._models(twin, forward == "scan_charm")
        x = twin["x"]
        n_px = x.shape[0] * x.shape[1] * x.shape[2]
        xs = torch.from_numpy(x)
        with torch.no_grad():
            f32 = tm(xs)
            tnn.set_activation_dtype(BF16)
            out = tm(xs)
        jnn.set_activation_dtype(jnp.bfloat16)
        ref = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))(
            params, jnp.asarray(x))
        assert str(out["x_hat"].dtype).split(".")[-1] == np.asarray(ref["x_hat"]).dtype.name
        assert {v.dtype for g in self.keys for v in out[g].values()} == {torch.float32}
        bpp = self._bpp(out, n_px)
        for key in self.image_keys:
            _assert_bf16_close(f"{self.name} {forward} {key}: port bf16 against JAX bf16",
                               out[key].float(), bpp, ref[key], self._bpp(ref, n_px))
            _assert_bf16_close(f"{self.name} {forward} {key}: port bf16 against port f32",
                               out[key].float(), bpp, f32[key], self._bpp(f32, n_px))

    @pytest.mark.parametrize("forward", ["unrolled", "scan_charm"])
    def test_train_step_bf16_matches_jax_bf16(self, twin, forward, monkeypatch):
        """One training step under the policy, the same noise in both, both
        layers' rates: float32 gradients on float32 masters, all finite (the
        split decoder's none: no loss term reads machine_x_hat); loss, bpp
        and MSE within 5% of JAX's bfloat16 training forward and mean
        |x_hat difference| under 0.01; the aux loss within 1e-5."""
        scan = forward == "scan_charm"
        jm, params, tm = self._models(twin, scan)
        x = twin["x"]
        jax_noise, port_noise = _noise(tm, x, scan, coder_paths=self.coder_paths)
        tr, jr = _replay(monkeypatch, jax_noise)
        tr.noise = port_noise
        key = jax.random.PRNGKey(0)
        jnn.set_activation_dtype(jnp.bfloat16)

        def terms(p):
            out = jm.apply({"params": p}, jnp.asarray(x), training=True, rngs={"noise": key})
            rd = JaxRD(0.01, likelihood_keys=self.keys)(out, jnp.asarray(x))
            return {**rd, "aux_loss": jm.apply({"params": p}, method=jm.aux_loss)}, out["x_hat"]

        ref_m, ref_x_hat = jax.jit(terms)(params)
        assert jr.i == len(jax_noise)

        tm.train()
        tnn.set_activation_dtype(BF16)
        state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 1.0))
        seen = {}
        handle = tm.register_forward_hook(
            lambda m, a, out: seen.update(x_hat=out["x_hat"].detach()))
        metrics = ttrain.make_train_step(
            tm, ttrain.RateDistortionLoss(0.01, likelihood_keys=self.keys))(
            state, torch.from_numpy(x), torch.Generator())
        handle.remove()
        assert tr.i == len(port_noise)
        grads = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
        assert set(grads) == {n for n, _ in tm.named_parameters()
                              if not n.startswith(self.fixed)}
        assert {g.dtype for g in grads.values()} == {torch.float32}
        assert all(torch.isfinite(g).all() for g in grads.values())
        assert {p.dtype for p in tm.parameters()} == {torch.float32}
        got = {k: float(v) for k, v in metrics.items()}
        print(f"{self.name} {forward} bf16 step: port {got}, JAX "
              f"{ {k: float(v) for k, v in ref_m.items()} }")
        for k in ("loss", "bpp_loss", "mse_loss"):
            assert got[k] == pytest.approx(float(ref_m[k]), rel=BPP_RTOL), k
        assert got["aux_loss"] == pytest.approx(float(ref_m["aux_loss"]), rel=1e-5)
        mean = float(np.abs(seen["x_hat"].float().numpy()
                            - np.asarray(ref_x_hat, np.float32)).mean())
        assert mean < XHAT_MEAN_TOL

    def test_codec_bf16_round_trips_on_both_wires(self, twin):
        """Compress and decompress under the policy on the host and the
        device wire: bit-exact, the device wire's y_hat and x_hat the host
        wire's; mean |x_hat difference| under 0.01 against float32 and
        against JAX's bfloat16 codec; under 2% of the machine y symbols
        differ from JAX's bfloat16 codec on each wire. (The streams are
        tens of bytes an image, so a symbol or two moves their bytes by a
        few percent: the rate is held by the eval forward's likelihoods.)"""
        tm, x = twin["tm"], twin["x"]
        xs = torch.from_numpy(x)
        jm, variables = twin["jm"], {"params": twin["params"]}
        jnn.set_activation_dtype(jnp.bfloat16)  # before the JAX codecs trace
        jc = on_wires(self.jax_codec(jm, variables, wire="device"))
        jenc = {w: c.compress(jnp.asarray(x), return_debug=True) for w, c in jc.items()}
        jnn.set_activation_dtype(None)
        tables = jax_tables(jc["device"])
        f32 = self.codec(tm, tables=tables).compress(xs, return_debug=True)
        tnn.set_activation_dtype(BF16)
        enc = {}
        for w in ("host", "device"):
            codec = self.codec(tm, tables=tables, wire=w)
            e = enc[w] = codec.compress(xs, return_debug=True)
            d = self.decompress(codec, e)
            for k in self.latent_keys:
                assert e[k].dtype == BF16
                assert torch.equal(d[k], e[k]), k
            assert torch.equal(d["x_hat"], e["x_hat"])
        for k in self.latent_keys + ("x_hat",):
            assert torch.equal(enc["device"][k], enc["host"][k]), k
        for against, ref in (("f32", f32["x_hat"]), ("JAX bf16", jenc["host"]["x_hat"])):
            mean = float(np.abs(enc["host"]["x_hat"].float().numpy()
                                - np.asarray(ref, np.float32)).mean())
            print(f"{self.name} codec bf16 against {against}: mean |x_hat difference| {mean:.2e}")
            assert mean < XHAT_MEAN_TOL, against
        for w in ("host", "device"):
            for k in self.latent_keys:
                share = float((np.abs(nhwc(enc[w][k].float())
                                      - np.asarray(jenc[w][k], np.float32)) > 0.5).mean())
                print(f"{self.name} {w} wire: {k} symbols that differ from JAX's bfloat16 "
                      f"codec: {share:.2e} (bar {SYMBOL_SHARE_TOL}); bytes "
                      f"{[sum(map(len, s)) for s in enc[w]['strings']]}, JAX "
                      f"{[sum(map(len, s)) for s in jenc[w]['strings']]}")
                assert share <= SYMBOL_SHARE_TOL, (w, k)


class CRC3Bf16Twin(CRC3Layout, CRCBf16Twin):
    """stf13's :class:`CRCBf16Twin`: x_hat, machine_x_hat and seg_x_hat, the
    three layers' rates, both zigzag layers' symbols."""

    def test_stf13_segmentation_latent_is_zero_at_init(self, twin):
        """At an untrained init stf13's segmentation latent rounds to 0
        everywhere, and with zero biases its mu and LRP are 0 as well: JAX's
        model at weights of its init's distributions (this twin's) and the
        port's seeded one (TINY,
        two 64 x 64 images, plain rounding) both give a seg_y_hat of exact
        zeros, coded as zero symbols, while the machine layer codes nonzero
        ones. So the model itself, not the port, leaves a card check on
        seeded weights comparing zeros; ``chip_smoke.CRC_GAIN`` scales the
        segmentation analysis's last convolution, after which the port codes
        nonzero segmentation symbols."""
        x = twin["x"]
        jenc = self.jax_codec(twin["jm"], {"params": twin["params"]}).compress(
            jnp.asarray(x), return_debug=True)
        assert not np.asarray(jenc["seg_y_hat"]).any()
        assert np.asarray(jenc["y_hat"]).any()
        tm = tmodels.create_model("stf13", device="cpu", seed=0, **TINY).eval()
        codec = CRC3Codec(tm)
        assert not codec.compress(x, return_debug=True)["seg_y_hat"].any()
        nonzero = {k: sum(int(s.count_nonzero()) for s in v) for k, v in codec.symbols(x).items()}
        assert nonzero["seg_y_hat"] == 0 and nonzero["y_hat"] > 0, nonzero
        with torch.no_grad():
            tm.seg_g_a2.Conv_1.weight.mul_(16.0)
        assert sum(int(s.count_nonzero()) for s in codec.symbols(x)["seg_y_hat"]) > 0
