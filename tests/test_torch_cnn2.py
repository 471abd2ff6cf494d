"""``cnn2`` (``WACNN2``: WACNN with a RetinaNet student on the decoded
image): icm_tpu_torch against the JAX package.

The narrow twin at ``tests/test_icm_models.py``'s config (N 16, M 24, 6
slices; the student a basic-block ResNet of one block a stage, 4 classes)
on two 64 x 64 images. The codec's parameters are drawn as the narrow
WACNN's (``test_torch_cnn_codec._params_from_numpy``), the student's as
``test_torch_tasks.draw_variables`` draws a task network (BatchNorm off
its init), its classification bias at the focal-loss prior so that a few
percent of the scores pass the detection threshold; the JAX variables
``{"params", "batch_stats"}`` carried over with ``from_jax_params``.

Held here: every JAX variable has its entry in the port's state dict; the
eval forward (x_hat, both likelihoods and every student output within
1e-4, the anchors equal); on the host wire (``CharmCodec``), the device
wire (``DeviceWireCodec``) and the scan wire (``scan_wire=True``) the
round trip bit for bit, the y and z streams byte for byte with JAX's
(the scan wire's tier byte included; the port's codecs take the JAX
codecs' tables) and decoding across the two frameworks both ways; the
detections of ``decompress_detect`` against JAX's student and
``decode_detections`` on JAX's decoded image; the registry's full-width
model (113 M parameters). One JAX ``DeviceWireCodec`` serves the device
and the scan wire (its ``scan_wire`` read at each call), so that they
share its compiled functions. The float64 training step is in
``test_torch_cnn2_train.py``, the bfloat16 policy in
``test_torch_cnn2_bf16.py``; the full-width eval forward on 64 x 64 is
``slow`` (``-m slow -k cnn2``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL
from test_torch_cnn_codec import _params_from_numpy as cnn_params
from test_torch_stf_family import port_tables
from test_torch_tasks import draw_variables

from icm_tpu.models import CharmCodec as JaxCharmCodec
from icm_tpu.models import WACNN as JaxWACNN
from icm_tpu.models import models as jax_models
from icm_tpu.models.device_codec import DeviceWireCodec as JaxDeviceWireCodec
from icm_tpu.tasks.retinanet import RetinaNet as JaxRetinaNet
from icm_tpu.tasks.retinanet import decode_detections as jax_decode
from icm_tpu_torch import models as tmodels
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params

torch.set_num_threads(2)

# tests/test_icm_models.py's cnn2 config
CODEC_TINY = dict(N=16, M=24, num_slices=6, max_support_slices=5,
                  hyper_enc_widths=(24, 20, 16, 14, 12), hyper_dec_widths=(12, 14, 16, 20, 24),
                  cc_widths=(16, 12, 10, 8))
TASK_TINY = dict(num_classes=4, task_block="basic", task_layers=(1, 1, 1, 1))
TINY = {**CODEC_TINY, **TASK_TINY}
# the eval forward of the two frameworks: f32 sums in another order
FORWARD_TOL = 1e-4
LANES = 4
# the wires: (the codec's wire, scan_wire)
WIRES = {"host": ("host", False), "device": ("device", False), "scan": ("device", True)}
STUDENT_KEYS = ("Student_classification", "Student_regression", "decompressH")
# the student's classification kernel x this: its logits spread about the
# prior so that a few percent of the scores pass the 0.05 threshold
CLS_GAIN = 10.0


def images(size=(64, 64), seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((2, *size, 3)).astype(np.float32)


def draw_cnn2(x, seed: int = 1, config=None) -> dict:
    """The twin's variables ``{"params", "batch_stats"}`` (module
    docstring), at ``config``'s widths (default ``TINY``)."""
    config = TINY if config is None else config
    codec_cfg = {k: v for k, v in config.items() if k not in TASK_TINY}
    params = dict(cnn_params(JaxWACNN(**codec_cfg), x, seed)["params"])
    student = JaxRetinaNet(num_classes=config.get("num_classes", 80),
                           block=config.get("task_block", "bottleneck"),
                           layers=config.get("task_layers", (3, 4, 6, 3)))
    shapes = jax.eval_shape(lambda: student.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    sv = draw_variables(shapes, seed + 1)
    out = sv["params"]["classification"]["output"]
    out["bias"] = (out["bias"] - np.log(99.0)).astype(np.float32)
    out["kernel"] = (CLS_GAIN * out["kernel"]).astype(np.float32)
    params["studentNet"] = sv["params"]
    return {"params": params, "batch_stats": {"studentNet": sv["batch_stats"]}}


def make_twin(size=(64, 64), seed: int = 1):
    """-> (JAX WACNN2, its variables, the port's model with them, x)."""
    x = images(size)
    jcls, jkw = jax_models["cnn2"]
    jm = jcls(**{**jkw, **TINY})
    variables = draw_cnn2(x, seed)
    tm = tmodels.create_model("cnn2", device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    return jm, variables, tm.eval(), x


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def jax_eval(jm, variables, x):
    return jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, jnp.asarray(x))


class JaxWire:
    """JAX's codec on one wire: the host wire's ``CharmCodec``, or one
    ``DeviceWireCodec`` built with ``scan_wire=True`` whose ``scan_wire``
    is set at each call."""

    def __init__(self, codec, scan_wire=None):
        self.codec, self.scan_wire = codec, scan_wire

    def _set(self):
        if self.scan_wire is not None:
            self.codec.scan_wire = self.scan_wire

    def compress(self, *a, **kw):
        self._set()
        return self.codec.compress(*a, **kw)

    def decompress(self, *a, **kw):
        self._set()
        return self.codec.decompress(*a, **kw)


def port_codec(tm, wire: str, tables, **kw):
    if wire == "host":
        return tmodels.CharmCodec(tm, tables=tables, **kw)
    return tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, tables=tables,
                                   scan_wire=WIRES[wire][1], **kw)


def pytest_generate_tests(metafunc):
    """A twin class's ``wire`` argument over its ``wires``."""
    if "wire" in metafunc.fixturenames and metafunc.cls is not None:
        metafunc.parametrize("wire", metafunc.cls.wires)


class TestCnn2:
    wires = ("host", "device", "scan")

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin()
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        host = JaxCharmCodec(jm, variables)
        dev = JaxDeviceWireCodec(jm, variables, lanes_per_image=LANES, scan_wire=True)
        jc = {"host": JaxWire(host), "device": JaxWire(dev, False), "scan": JaxWire(dev, True)}
        tables = {"host": port_tables(host.tables), "device": port_tables(dev.tables)}
        port = {w: port_codec(tm, w, tables["host" if w == "host" else "device"])
                for w in self.wires}
        return dict(jm=jm, variables=variables, tm=tm, x=x, jc=jc, port=port,
                    ref=jax_eval(jm, variables, x),
                    jenc={w: c.compress(xj, return_debug=True) for w, c in jc.items()},
                    enc={w: c.compress(xt, return_debug=True) for w, c in port.items()})

    def test_state_dict_covers_every_jax_variable(self, twin):
        """Every parameter and BatchNorm statistic, and nothing else."""
        v = twin["variables"]
        n_jax = sum(len(jax.tree_util.tree_leaves(v[k])) for k in ("params", "batch_stats"))
        sd = twin["tm"].state_dict()
        assert n_jax == len(sd)
        assert len(jax.tree_util.tree_leaves(v["batch_stats"])) == 2 * sum(
            k.endswith(".mean") for k in sd)

    def test_eval_forward_matches_jax(self, twin):
        """x_hat, both likelihoods, the student's C2 (``decompressH``), its
        [C3, C4, C5], classification and regression within 1e-4; the
        anchors equal; JAX's None fields None."""
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]))
        ref = twin["ref"]
        pairs = [(out["x_hat"], ref["x_hat"], "x_hat")]
        pairs += [(out["likelihoods"][k], ref["likelihoods"][k], k) for k in "yz"]
        pairs += [(out[k], ref[k], k) for k in STUDENT_KEYS]
        pairs += [(a, b, f"C{i + 3}") for i, (a, b) in enumerate(
            zip(out["Student_output_features"], ref["Student_output_features"]))]
        print("cnn2: largest |port - JAX|:",
              {n: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, n in pairs})
        for a, b, n in pairs:
            assert tuple(a.shape) == b.shape, n
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=n)
        np.testing.assert_array_equal(out["Student_anchors"].numpy(),
                                      np.asarray(ref["Student_anchors"]))
        assert len(out["Student_output_features"]) == 3
        for k in ("compressH", "Teacher_output_features"):
            assert out[k] is None and ref[k] is None
        share = float((out["Student_classification"] > 0.05).float().mean())
        print(f"cnn2: scores above 0.05: {share:.2%}")
        assert 0.005 < share < 0.2, share

    def test_roundtrip_bitexact(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["port"][wire].decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape

    @pytest.mark.parametrize("stream", ["y", "z"])
    def test_streams_match_jax_byte_for_byte(self, twin, wire, stream):
        k = "yz".index(stream)
        got, want = twin["enc"][wire]["strings"][k], twin["jenc"][wire]["strings"][k]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"{wire} {stream} stream of image {b}: {len(g)} vs {len(w)} bytes"
        if wire == "scan" and stream == "y":  # JAX's scan-wire framing and tier byte
            assert all(g[3] == WIRE_SCAN and g[4] in (0, 1, 2) for g in got)

    def test_symbols_are_nonzero_and_match_jax(self, twin, wire):
        enc, jenc = twin["enc"][wire], twin["jenc"][wire]
        port_y, jax_y = nhwc(enc["y_hat"]), np.asarray(jenc["y_hat"])
        flipped = np.abs(port_y - jax_y) > 0.5
        assert flipped.sum() == 0
        np.testing.assert_allclose(port_y, jax_y, rtol=0, atol=CROSS_TOL)
        assert len(b"".join(enc["strings"][0])) > 2 * 64  # not an all-zero latent

    def test_port_decodes_the_jax_streams(self, twin, wire):
        jenc = twin["jenc"][wire]
        dec = twin["port"][wire].decompress(jenc["strings"], jenc["shape"])
        np.testing.assert_allclose(nhwc(dec["y_hat"]), np.asarray(jenc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        # the synthesis of (nearly) the port encoder's y_hat
        np.testing.assert_allclose(dec["x_hat"].numpy(), twin["enc"][wire]["x_hat"].numpy(),
                                   rtol=0, atol=FORWARD_TOL)

    def test_jax_decodes_the_port_streams(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["jc"][wire].decompress(enc["strings"], enc["shape"])
        np.testing.assert_allclose(np.asarray(dec["y_hat"]), nhwc(enc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(), rtol=0,
                                   atol=FORWARD_TOL)

    def test_decompress_detect_matches_jax(self, twin, wire):
        """The serving call on JAX's streams against JAX's detection loop
        (``tools/eval_model.py``: its decompress, ``studentNet`` on x_hat,
        ``decode_detections`` an image): the classification and regression
        maps within 1e-4 and the anchors equal, and each image's detections
        those of JAX's ``decode_detections`` on the port's maps, array for
        array. Detections are not held box for box across the frameworks:
        on the twin's smooth x_hat neighbouring cells score alike to a few
        ulps, and greedy NMS keeps whichever of such a pair its rounding
        sorts first."""
        jm, variables = twin["jm"], twin["variables"]
        jenc = twin["jenc"][wire]
        got = tmodels.decompress_detect(twin["port"][wire], jenc["strings"], jenc["shape"],
                                        image_hw=(60, 64))
        x_hat = twin["jc"][wire].decompress(jenc["strings"], jenc["shape"])["x_hat"]
        _, _, cls, reg, anchors = jm.apply(variables, x_hat,
                                           method=lambda mdl, xx: mdl.studentNet(xx))
        np.testing.assert_allclose(got["classification"].numpy(), np.asarray(cls), rtol=0,
                                   atol=FORWARD_TOL)
        np.testing.assert_allclose(got["regression"].numpy(), np.asarray(reg), rtol=0,
                                   atol=FORWARD_TOL)
        np.testing.assert_array_equal(got["anchors"].numpy(), np.asarray(anchors))
        assert len(got["detections"]) == 2
        maps = [got[k].numpy() for k in ("classification", "regression", "anchors")]
        for b, dets in enumerate(got["detections"]):
            want = jax_decode(maps[0][b:b + 1], maps[1][b:b + 1], maps[2], (60, 64))
            assert len(want[0]) > 0
            for g, w in zip(dets, want):
                np.testing.assert_array_equal(g, w)
            assert dets[2][:, 2].max() <= 64 and dets[2][:, 3].max() <= 60


def test_decompress_detect_needs_the_student():
    tm = tmodels.create_model("cnn2", device="cpu", with_task_net=False, **CODEC_TINY)
    assert not hasattr(tm, "studentNet")
    codec = tmodels.CharmCodec(tm)
    enc = codec.compress(torch.from_numpy(images()))
    with pytest.raises(ValueError, match="studentNet"):
        tmodels.decompress_detect(codec, enc["strings"], enc["shape"])
    out = tm(torch.from_numpy(images()))
    assert out["Student_classification"] is None and out["x_hat"].shape == (2, 64, 64, 3)


def test_registry_builds_cnn2_at_full_width():
    """The JAX registry's cnn2 (its defaults: WACNN's N 192, M 320, 10
    slices; RetinaNet-ResNet-50, 80 classes) on the meta device: 113.2 M
    parameters, cnn's 75.2 M and the student's 38.0 M."""
    cls, kwargs = tmodels.models["cnn2"]
    jcls, jkwargs = jax_models["cnn2"]
    assert cls is tmodels.WACNN2 and kwargs == jkwargs == {}
    with torch.device("meta"):
        m = cls(**kwargs)
        cnn = tmodels.models["cnn"][0]()
    n, n_cnn = (sum(p.numel() for p in mm.parameters()) for mm in (m, cnn))
    n_student = sum(p.numel() for p in m.studentNet.parameters())
    print(f"cnn2 {n / 1e6:.2f} M parameters: cnn {n_cnn / 1e6:.2f} M + student "
          f"{n_student / 1e6:.2f} M")
    assert n == n_cnn + n_student and round(n / 1e5) == 1132 and round(n_student / 1e5) == 380
    assert m.studentNet.classification.output.out_channels == 9 * 80
    assert (m.studentNet.backbone.layers, m.N, m.M, m.num_slices) == ((3, 4, 6, 3), 192, 320, 10)


@pytest.mark.slow
def test_full_width_eval_forward_matches_jax():
    """The full-width cnn2 against its JAX twin on one 64 x 64 image, the
    codec's parameters drawn as the full-width WACNN's, the student's as
    the narrow twin's: x_hat, the likelihoods and the student's outputs
    within 1e-4, the anchors equal."""
    x = images()[:1]
    jcls, jkw = jax_models["cnn2"]
    jm = jcls(**jkw)
    variables = draw_cnn2(x, seed=4, config={})
    tm = tmodels.create_model("cnn2", device="cpu")
    tm.load_state_dict(from_jax_params(variables), strict=True)
    ref = jax_eval(jm, variables, x)
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x))
    for name in ("x_hat",) + STUDENT_KEYS:
        np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL, err_msg=name)
    for k in "yz":
        np.testing.assert_allclose(out["likelihoods"][k].numpy(),
                                   np.asarray(ref["likelihoods"][k]), rtol=FORWARD_TOL,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out["Student_anchors"].numpy(),
                                  np.asarray(ref["Student_anchors"]))
