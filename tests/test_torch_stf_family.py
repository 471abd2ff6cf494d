"""The zigzag Swin family ``stf5``-``stf8``: icm_tpu_torch against the JAX
package.

Narrow twins (the Swin transforms of ``tests/test_stf_family.py``'s
``TINY_SWIN``) of its three context configurations, ``stf6like`` (zigzag,
sliding support, window conditioning, a mu refiner), ``stf5like``
(channel slices, prefix support, full conditioning, all three refiners)
and ``stf8like`` (stf8's unconstrained zigzag, a look-ahead window of 8
mean blocks clamped at the tail), plus ``stf7like`` (prefix support,
refiners at window 8, which pads the 4 x 4 slices), on two 64 x 64
images. The JAX twin's parameters are drawn with numpy at the shapes of
its init (``jax.eval_shape``; the eager init takes about a minute a twin
on a CPU) and carried over with ``from_jax_params``; each twin's JAX
results are computed once for its tests. Each twin's tests live in a file
of their own (``test_torch_stf_family_*.py``), so that the suite's
workers run the twins side by side; this file holds what they share and
the family's other tests.

Held for each twin: the eval forward (x_hat within 1e-4, likelihoods
within 1e-5), the host wire's y and z symbols and its y streams identical
to the JAX codec's, decoding across the two frameworks both ways, the
device wire's blobs byte for byte with the JAX ``DeviceWireCodec``'s, and
the round trips bit-exact. The bottleneck's CDF tables, built in each
framework from the same density, can differ by one step of a CDF (float
rounding: one row of stf8like's by 1 in 65536), and then z's streams
differ though its symbols do not, and neither side reads the other's; so
the port's codecs take the JAX codecs' tables (``tables=``), as a
reference checkpoint's stored tables are handed over
(``test_torch_zoo.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL, JaxHostWire
from test_torch_stf import _assert_forward_close, _params_from_numpy

from icm_tpu.models import ZigzagSwinCodec as JaxZigzag
from icm_tpu.models import models as jax_models
from icm_tpu.models.device_codec import DeviceWireCodec as JaxDeviceWireCodec
from icm_tpu_torch import models as tmodels
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.entropy import EntropyTables
from icm_tpu_torch.nn.swin import SwinBlock

torch.set_num_threads(2)

# tests/test_stf_family.py's TINY_SWIN
TINY_SWIN = dict(
    embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4, patch_size=2,
    hyper_enc_widths=(64, 56, 48, 40, 32), hyper_dec_widths=(40, 48, 56, 64, 64),
    cc_widths=(24, 20, 16, 12), drop_path_rate=0.1,
)
# each twin's registry name (the preset it stands for) and its context
TWINS = {
    "stf6like": ("stf6", dict(
        num_slices=4, spatial_number=2, support_mode="sliding", max_support=6,
        mean_mode="window", mean_window=1, mu_refine=(1, 1), scale_refine=(), lrp_refine=(),
        refine_window=4, zigzag_constrained=True)),
    "stf5like": ("stf5", dict(
        num_slices=4, spatial_number=1, support_mode="prefix", max_support=2,
        mean_mode="full", mu_refine=(1,), scale_refine=(1,), lrp_refine=(1,),
        refine_window=4)),
    "stf8like": ("stf8", dict(
        num_slices=4, spatial_number=2, support_mode="sliding", max_support=4,
        mean_mode="window", mean_window=8, mu_refine=(1,), scale_refine=(1,),
        lrp_refine=(1,), refine_window=4, zigzag_constrained=False)),
    "stf7like": ("stf7", dict(
        num_slices=4, spatial_number=1, support_mode="prefix", max_support=2,
        mean_mode="full", mu_refine=(2,), scale_refine=(1,), lrp_refine=(2,),
        refine_window=8)),
}


def make_twin(name: str, seed: int = 1):
    """-> (JAX model, its variables, the port's model with them, images)."""
    preset, ctx = TWINS[name]
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    jm = JaxZigzag(**TINY_SWIN, **ctx)
    variables = _params_from_numpy(jm, x, seed=seed)
    tm = tmodels.create_model(preset, device="cpu", **TINY_SWIN, **ctx)
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return jm, variables, tm.eval(), x


def port_tables(jt) -> tmodels.CodecTables:
    """The JAX package's ``CodecTables`` as the port's (numpy arrays)."""
    def one(t):
        return EntropyTables(*(np.asarray(getattr(t, f))
                               for f in ("quantized_cdf", "cdf_length", "offset")))
    return tmodels.CodecTables(gaussian=one(jt.gaussian), scale_table=np.asarray(jt.scale_table),
                               bottlenecks={k: one(t) for k, t in jt.bottlenecks.items()})


class OnWire:
    """A JAX codec on one wire: the JAX codecs read their ``wire`` (and
    ``scan_wire``) at each call, so one instance, built for the device wire
    (and the scan wire), serves every wire, and they share its compiled
    functions."""

    def __init__(self, codec, wire: str, scan_wire: bool = False):
        self.codec, self.wire, self.scan_wire = codec, wire, scan_wire

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def _set(self):
        self.codec.wire = self.wire
        if hasattr(self.codec, "scan_wire"):
            self.codec.scan_wire = self.scan_wire

    def compress(self, *args, **kwargs):
        self._set()
        return self.codec.compress(*args, **kwargs)

    def decompress(self, *args, **kwargs):
        self._set()
        return self.codec.decompress(*args, **kwargs)


def on_wires(codec, wires=("host", "device")) -> dict:
    """``codec`` (built with ``wire="device"``) as an :class:`OnWire` each."""
    return {w: OnWire(codec, w) for w in wires}


class FamilyTwin:
    """The tests of one twin; a file per twin subclasses it as
    ``Test<Twin>`` with ``name`` set."""

    name = ""

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin(self.name)
        xj = jnp.asarray(x)
        ref = jax.jit(lambda v, x: jm.apply(v, x, training=False))(variables, xj)
        # one JAX codec serves both wires, which share its compiled functions
        jdev = JaxDeviceWireCodec(jm, variables, lanes_per_image=4)
        jc = JaxHostWire(jdev)
        host = tmodels.CharmCodec(tm, tables=port_tables(jc.tables))
        dev = tmodels.DeviceWireCodec(tm, lanes_per_image=4, tables=port_tables(jdev.tables))
        return dict(jm=jm, variables=variables, tm=tm, x=x, ref=ref, jc=jc,
                    jenc=jc.compress(xj, return_debug=True), host=host,
                    enc=host.compress(torch.from_numpy(x), return_debug=True),
                    jdev_enc=jdev.compress(xj, return_debug=True), dev=dev,
                    dev_enc=dev.compress(torch.from_numpy(x), return_debug=True))

    def test_state_dict_covers_every_jax_parameter(self, twin):
        assert (len(jax.tree_util.tree_leaves(twin["variables"]["params"]))
                == len(twin["tm"].state_dict()))

    def test_eval_forward_matches_jax(self, twin):
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]))
        _assert_forward_close(out, twin["ref"])

    def test_host_wire_roundtrip_bitexact(self, twin):
        enc = twin["enc"]
        dec = twin["host"].decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape

    def test_host_wire_symbols_match_jax(self, twin):
        """0 of the y symbols differ from the JAX codec's, and z's symbols
        are its symbols: the streams are its streams byte for byte."""
        port_y = twin["enc"]["y_hat"].permute(0, 2, 3, 1).numpy()
        jax_y = np.asarray(twin["jenc"]["y_hat"])
        flipped = np.abs(port_y - jax_y) > 0.5
        print(f"y symbols that differ from the JAX codec: {flipped.sum()} of {flipped.size}")
        assert flipped.sum() == 0
        np.testing.assert_allclose(port_y, jax_y, atol=CROSS_TOL)
        assert twin["enc"]["strings"] == twin["jenc"]["strings"]
        np.testing.assert_array_equal(twin["enc"]["z_hat"].permute(0, 2, 3, 1).numpy(),
                                      np.asarray(twin["jenc"]["z_hat"]))

    def test_port_decodes_the_jax_codec_strings(self, twin):
        jenc = twin["jenc"]
        dec = twin["host"].decompress(jenc["strings"], jenc["shape"])
        np.testing.assert_allclose(dec["y_hat"].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jenc["y_hat"]), rtol=0, atol=CROSS_TOL)

    def test_jax_codec_decodes_the_port_strings(self, twin):
        enc = twin["enc"]
        dec = twin["jc"].decompress(enc["strings"], enc["shape"])
        np.testing.assert_allclose(np.asarray(dec["y_hat"]),
                                   enc["y_hat"].permute(0, 2, 3, 1).numpy(),
                                   rtol=0, atol=CROSS_TOL)
        np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(),
                                   rtol=1e-4, atol=1e-4)

    def test_device_wire_roundtrip_bitexact(self, twin):
        """4 lanes a slice image; y_hat equal to the host wire's; one
        decode a slice and one for z."""
        enc = twin["dev_enc"]
        dec = twin["dev"].decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert torch.equal(dec["x_hat"], enc["x_hat"])
        assert torch.equal(enc["y_hat"], twin["enc"]["y_hat"])

    @pytest.mark.parametrize("stream", ["y", "z"])
    def test_device_wire_bytes_match_jax(self, twin, stream):
        k = "yz".index(stream)
        got, want = twin["dev_enc"]["strings"][k], twin["jdev_enc"]["strings"][k]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"{stream} wire of image {b}: {len(g)} vs {len(w)} bytes"

    def test_port_decodes_the_jax_device_wire(self, twin):
        jenc = twin["jdev_enc"]
        dec = twin["dev"].decompress(jenc["strings"], jenc["shape"])
        np.testing.assert_allclose(dec["y_hat"].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jenc["y_hat"]), rtol=0, atol=CROSS_TOL)


# --- the family's other tests -------------------------------------------------------

# refiner Swin blocks a side: per slice, the blocks of each enabled refiner
PRESETS = {"stf5": (12, 32, 432), "stf6": (24, 64, 288), "stf6_2": (24, 64, 288),
           "stf7": (12, 32, 240), "stf8": (24, 64, 480)}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_are_the_published_configs(name):
    """The port's registry holds the JAX package's config for each name;
    built (on the meta device: the full-width weights are not drawn
    here), each has its context slices, slice width and refiner blocks,
    and every refiner attends at 4 heads of width slice / 4."""
    cls, kwargs = tmodels.models[name]
    jcls, jkwargs = jax_models[name]
    assert cls is tmodels.ZigzagSwinCodec and jcls is JaxZigzag
    assert kwargs == jkwargs
    with torch.device("meta"):
        m = cls(**kwargs)
    slices, width, blocks = PRESETS[name]
    assert (m.ctx_slices, m.slice_ch) == (slices, width)
    refiners = [b for n, b in m.named_modules() if "_refine_" in n and isinstance(b, SwinBlock)]
    assert len(refiners) == blocks
    assert {(b.attn.num_heads, b.attn.dim // b.attn.num_heads) for b in refiners} == {
        (4, width // 4)}


def test_create_model_builds_a_preset_at_full_width():
    """``create_model`` draws a published preset's weights from the seed
    (stf7, the family's smallest: 103 M parameters)."""
    m = tmodels.create_model("stf7", device="cpu", seed=3)
    assert sum(p.numel() for p in m.parameters()) == 103_120_599
    assert all(torch.isfinite(p).all() for p in m.parameters())
    table = m.mu_refine_0.stage0.block1.attn.relative_position_bias_table
    assert table.shape == (15 * 15, 4) and 0 < float(table.detach().std()) < 0.05


# the full-width stf8 against JAX: in float64 the two agree to 2.7e-13 (x_hat)
# and 1.2e-13 (y likelihoods). In float32 each strays from that in its own
# summation order, most of it along the 16 slices' context chain, whose mu
# feeds y_hat: JAX by 8.9e-5 (x_hat) and 2.1e-5 (y likelihoods), the port by
# 2.2e-4 and 8.4e-5; the two float32 results are 1.9e-4 and 7.0e-5 apart.
# The float32 bars (atol, rtol) take three times JAX's own float32 against
# float64 reading on this image (x_hat's rounded up) where the narrow twins'
# bars (x_hat 1e-4, likelihoods 1e-5, relative 1e-4) are below it; z keeps
# the twins' bar
FULL_WIDTH_F64_TOL = 1e-9
FULL_WIDTH_F32_BARS = {"x_hat": (3e-4, 0), "y": (6.3e-5, 1e-4), "z": (1e-5, 1e-4)}


@pytest.mark.slow
def test_full_width_stf8_eval_forward_matches_jax():
    """The full-width stf8 against its JAX twin on one 128 x 128 image, the
    same weights (drawn in float32): in float64 on both sides (JAX under
    ``enable_x64``, the port ``.double()``) x_hat and the likelihoods
    within 1e-9; in float32 within FULL_WIDTH_F32_BARS, set from JAX's own
    float32 against float64 reading."""
    x = np.random.default_rng(3).random((1, 128, 128, 3)).astype(np.float32)
    jm = JaxZigzag(**jax_models["stf8"][1])
    # float32 values, as the port's state dict holds them (the draw gives
    # float64 arrays, which JAX's float64 run would otherwise keep)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jax.device_get(_params_from_numpy(jm, x, seed=4)["params"]))
    tm = tmodels.create_model("stf8", device="cpu")
    tm.load_state_dict(from_jax_params(params), strict=True)
    apply = jax.jit(lambda p, a: jm.apply({"params": p}, a, training=False))
    ref32 = jax.device_get(apply(params, jnp.asarray(x)))
    with jax.enable_x64(True):
        ref64 = jax.device_get(apply(jax.tree_util.tree_map(lambda a: a.astype(np.float64), params),
                                     jnp.asarray(x.astype(np.float64))))
    with torch.no_grad():
        out32 = tm.eval()(torch.from_numpy(x))
        out64 = tm.double()(torch.from_numpy(x.astype(np.float64)))

    def fields(out):
        return {"x_hat": out["x_hat"], **out["likelihoods"]}

    print("JAX float32 against float64:", {k: float(np.abs(np.asarray(v) - fields(ref64)[k]).max())
                                           for k, v in fields(ref32).items()})
    for out, ref, dtype in ((out64, ref64, "float64"), (out32, ref32, "float32")):
        pairs = [(a, fields(ref)[name], name, FULL_WIDTH_F32_BARS[name] if dtype == "float32"
                  else (FULL_WIDTH_F64_TOL, 0)) for name, a in fields(out).items()]
        print(dtype, {name: float(np.abs(a.numpy() - b).max()) for a, b, name, _ in pairs})
        for a, b, name, (atol, rtol) in pairs:
            assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, name
            np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=atol, err_msg=name)
