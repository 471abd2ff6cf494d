"""``oj_ICM`` (``FasterRCNN_Coding``: the zigzag ChARM codec trained by
feature distillation through a frozen R50-FPN): icm_tpu_torch against the
JAX package.

The narrow twin at ``tests/test_icm_models.py``'s ``TINY_CODEC`` (N 16, M
24, mid 32, 2 x 2x2 zigzag = 8 slices, sliding support 4, a conditioning
window of 8, 3-conv context stacks, LRP) with the task net at ``task_layers
(1, 1, 1, 1)`` (P2-P6 at 256 channels), on two 64 x 64 images. The codec's
parameters are drawn as the CRC twins' (``test_torch_crc._draw_params``),
the task net's as ``test_torch_tasks.draw_variables`` draws one (BatchNorm
off its init); the JAX variables ``{"params", "batch_stats"}`` carried over
with ``from_jax_params``. The port's codecs take the JAX codecs' tables.

Held here: ``FPN`` and ``_FrozenFPN`` within 1e-5 of flax; the registry's
published widths; every JAX variable in the port's state dict; the eval
forward (x_hat, both likelihoods, the teacher's and the student's P2-P6)
within 1e-4; on the host wire (``CharmCodec``) and the device wire
(``DeviceWireCodec``) the round trip bit for bit, the y symbols JAX's, the
y and z streams byte for byte with JAX's and decoding across the two
frameworks both ways; the device wire's floats the host wire's;
``DeviceWireCodec(scan_wire=True)`` refused (JAX's serves its unrolled
device wire instead); one float64 step of ``DetectionICMLoss`` under
``freeze_patterns=("task_net",)`` against JAX autodiff: the loss terms and
every codec gradient within 1e-6 of its max, the task net without
gradients and unmoved. ``seg_oj_ICM`` is in ``test_torch_seg_oj.py``, the
reference conversions in ``test_torch_zoo_oj.py``. One JAX
``DeviceWireCodec`` serves both wires (``JaxHostWire``: its host wire is
``CharmCodec``'s own code), so that they share its compiled functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_icm_models import TINY_CODEC
from test_torch_cnn_codec import CROSS_TOL, JaxHostWire
from test_torch_crc import FORWARD_TOL, _draw_params
from test_torch_stf_family import port_tables
from test_torch_stf_family_paths import _f64_port_params
from test_torch_tasks import MODULE_TOL, _assert_close, draw_variables, load, nchw
from test_torch_train import _close, _replay

from icm_tpu.models import models as jax_models
from icm_tpu.models.device_codec import DeviceWireCodec as JaxDeviceWireCodec
from icm_tpu.models.icm import _FrozenFPN as JaxFrozenFPN
from icm_tpu.tasks import fpn as jfpn
from icm_tpu.train import DetectionICMLoss as JaxDetectionICMLoss
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import tasks
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.icm import _FrozenFPN

torch.set_num_threads(2)

TASK_TINY = dict(task_layers=(1, 1, 1, 1))
TINY = {**TINY_CODEC, **TASK_TINY}
LEVELS = ("p2", "p3", "p4", "p5", "p6")
# one float64 step: the same function in another order of sums
STEP_TOL = 1e-6
# the published widths' parameters: the JAX registry models' own counts
# (jax.eval_shape of their init), the task net's 26,852,416 of them
FULL_WIDTH_PARAMS = {"oj_ICM": 177_512_067, "seg_oj_ICM": 328_186_118}


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def images(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((2, 64, 64, 3)).astype(np.float32)


def draw_oj(name: str, x, seed: int = 1) -> dict:
    """The twin's variables ``{"params", "batch_stats"}`` (module
    docstring)."""
    jcls, jkw = jax_models[name]
    codec = jcls(**{**jkw, **TINY, "with_task_net": False})
    params = dict(_draw_params(codec, x, seed)["params"])
    task = JaxFrozenFPN(layers=TINY["task_layers"])
    tv = draw_variables(jax.eval_shape(lambda: task.init(jax.random.PRNGKey(0), jnp.asarray(x))),
                        seed + 1)
    params["task_net"] = tv["params"]
    return {"params": params, "batch_stats": {"task_net": tv["batch_stats"]}}


def make_twin(name: str, seed: int = 1):
    """-> (JAX model, its variables, the port's model with them, images)."""
    x = images()
    jcls, jkw = jax_models[name]
    jm = jcls(**{**jkw, **TINY})
    variables = draw_oj(name, x, seed)
    tm = tmodels.create_model(name, device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    return jm, variables, tm.eval(), x


def jax_eval(jm, variables, x):
    """-> (JAX's eval forward of x, its jitted function of (variables, x))."""
    fn = jax.jit(lambda v, a: jm.apply(v, a, training=False))
    return fn(variables, jnp.asarray(x)), fn


def assert_features_match(out: dict, ref: dict, tol: float, what: str) -> dict:
    """The teacher's and the student's P2-P6 of a port forward against
    JAX's. -> the largest differences."""
    err = {}
    for group in ("Teacher_output_features", "Student_output_features"):
        assert set(out[group]) == set(ref[group]) == set(LEVELS)
        for k in LEVELS:
            a, b = out[group][k].detach().float().numpy(), np.asarray(ref[group][k])
            assert a.shape == b.shape and a.shape[-1] == 256, (group, k)
            err[f"{group.split('_')[0]} {k}"] = float(np.abs(a - b).max())
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{what} {group} {k}")
    return err


# --- the task net's modules against flax ------------------------------------------

def test_fpn_matches_flax():
    """The P2-P6 pyramid over (C2, C3, C4, C5) of ResNet-50's widths: 1x1
    laterals, the nearest x2 top-down path, 3x3 outputs, P6 P5's every
    other pixel (flax's 1x1 max-pool at stride 2)."""
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal((2, s, s, c)).astype(np.float32)
             for s, c in ((16, 256), (8, 512), (4, 1024), (2, 2048))]
    jm = jfpn.FPN()
    variables = draw_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), feats)), 4)
    ref = jm.apply(variables, [jnp.asarray(c) for c in feats])
    tm = load(tasks.FPN(), variables)
    with torch.no_grad():
        out = tm([nchw(c) for c in feats])
    assert list(out) == list(ref) == list(LEVELS)
    assert [nhwc(out[k]).shape for k in LEVELS] == [
        (2, 16, 16, 256), (2, 8, 8, 256), (2, 4, 4, 256), (2, 2, 2, 256), (2, 1, 1, 256)]
    for k in LEVELS:
        _assert_close(nhwc(out[k]), ref[k], MODULE_TOL, k)


@pytest.mark.parametrize("name", sorted(FULL_WIDTH_PARAMS))
def test_registry_builds_the_published_widths(name):
    """The JAX class at its defaults, built on the meta device: its
    parameter count, a coder of 8 zigzag slices of 192 channels, support 4,
    a conditioning window of 8, 3-conv stacks and LRP (both coders of
    seg_oj_ICM), ResNet-50 with P2-P6, window attention at head widths 24,
    48 and 32 and GDN at 192 and 256 channels."""
    from icm_tpu_torch.nn import GDN, WinBasedAttention

    cls, kwargs = tmodels.models[name]
    jcls, jkwargs = jax_models[name]
    assert cls.__name__ == jcls.__name__ and kwargs == jkwargs == {}
    with torch.device("meta"):
        m = cls()
    assert sum(p.numel() for p in m.parameters()) == FULL_WIDTH_PARAMS[name]
    assert sum(p.numel() for p in m.task_net.parameters()) == 26_852_416
    coders = [m.coder] + ([m.seg_coder] if name == "seg_oj_ICM" else [])
    for c in coders:
        assert (c.ctx_slices, c.slice_ch, c.max_support, c.cond_blocks, c.apply_lrp) == (
            8, 192, 4, 8, True)
        assert len([n for n, _ in c.cc_mean_0.named_children() if n.startswith("Conv_")]) == 3
    assert m.task_net.ResNetBackbone_0.layers == (3, 4, 6, 3)
    heads = {mod.attn.dim // mod.attn.num_heads for mod in m.modules()
             if isinstance(mod, WinBasedAttention)}
    assert heads == {24, 48, 32}
    assert {mod.channels for mod in m.modules() if isinstance(mod, GDN)} == {192, 256}
    assert list(m.eb_dict()) == (["entropy_bottleneck", "seg_entropy_bottleneck"]
                                 if name == "seg_oj_ICM" else ["entropy_bottleneck"])


# --- the twin ------------------------------------------------------------------------

def train_noise(jm, x, seed: int = 5, layers: int = 1) -> list:
    """One training forward's noise, in the order both draw it: per zigzag
    layer z (the bottleneck's (C, 1, n) layout), then each slice's y
    (NHWC), the machine layer's first."""
    rng = np.random.default_rng(seed)
    B, H = x.shape[:2]
    hb = H // 16 // 2
    sc = jm.M // jm.num_slices
    noise = []
    for _ in range(layers):
        noise.append(rng.uniform(-0.5, 0.5, (jm.hyper_enc_widths[-1], 1, B * (H // 64) ** 2)))
        noise += [rng.uniform(-0.5, 0.5, (B, hb, hb, sc)) for _ in range(jm.num_slices * 4)]
    return noise


def step_against_jax(twin, monkeypatch, name: str, freeze, train_patterns=None):
    """One float64 step of the twin's weights: JAX's loss and its gradients
    with respect to the parameters the patterns leave trainable (the
    others closed over, as the optimizer zeroes theirs), against the port's
    ``make_train_step`` with the optimizer of the same patterns (no clip:
    it would scale the gradients read). -> (the port's model, its weights
    before the step, JAX's metrics, JAX's gradients in the port's names,
    the port's metrics)."""
    jm, x = twin["jm"], twin["x"]
    layers = 2 if name == "seg_oj_ICM" else 1
    tm = tmodels.create_model(name, device="cpu", **TINY)
    tm.load_state_dict(twin["tm"].state_dict())
    tm = tm.double()
    x64 = x.astype(np.float64)
    noise = train_noise(jm, x, layers=layers)
    tr, jr = _replay(monkeypatch, noise)
    key = jax.random.PRNGKey(0)
    labels = ttrain.label_params(tm, freeze, train_patterns)

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     jax.device_get(twin["variables"]))
        trainable = {n for n, lab in labels.items() if lab != "frozen"}
        top = {n.split(".")[0] for n in trainable}
        # the trainable subtrees at the top level, the rest closed over
        part = {k: v for k, v in v64["params"].items() if k in top}
        rest = {k: v for k, v in v64["params"].items() if k not in top}

        def loss_fn(p):
            v = {"params": {**rest, **p}, "batch_stats": v64["batch_stats"]}
            out = jm.apply(v, jnp.asarray(x64), training=True, rngs={"noise": key})
            m = JaxDetectionICMLoss(1.0)(out, jnp.asarray(x64))
            aux = jm.apply(v, method=jm.aux_loss)
            return m["loss"] + aux, {**m, "aux_loss": aux}

        (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(part)
        ref_m, ref_g = jax.device_get((ref_m, ref_g))
    assert jr.i == len(noise)
    ref_grads = _f64_port_params(ref_g, tm)
    assert trainable <= set(ref_grads)

    before = {k: v.clone() for k, v in tm.state_dict().items()}
    state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 0.0, freeze,
                                                        train_patterns))
    metrics = ttrain.make_train_step(tm, ttrain.DetectionICMLoss(1.0))(
        state, torch.from_numpy(x64), torch.Generator())
    assert tr.i == len(noise)
    got = {k: v.item() for k, v in metrics.items()}
    print(f"{name} float64 step: port {got}, JAX {ref_m}")
    for k, v in got.items():
        _close(v, ref_m[k], STEP_TOL, k)
    return tm, before, ref_grads, labels, got


class TestOj:
    """The narrow twin's eval forward, host and device wires and step."""

    wires = ("host", "device")

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin("oj_ICM")
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        jdev = JaxDeviceWireCodec(jm, variables)
        jc = {"host": JaxHostWire(jdev), "device": jdev}
        port = {"host": tmodels.CharmCodec(tm, tables=port_tables(jc["host"].tables)),
                "device": tmodels.DeviceWireCodec(tm, tables=port_tables(jc["device"].tables))}
        jenc = {w: c.compress(xj, return_debug=True) for w, c in jc.items()}
        # JAX's decoder's x_hat (its host wire's debug compress gives none)
        jdec = {w: c.decompress(jenc[w]["strings"], jenc[w]["shape"]) for w, c in jc.items()}
        return dict(jm=jm, variables=variables, tm=tm, x=x, ref=jax_eval(jm, variables, x)[0],
                    jc=jc, port=port, jenc=jenc, jdec=jdec,
                    enc={w: c.compress(xt, return_debug=True) for w, c in port.items()})

    def test_frozen_fpn_matches_flax(self, twin):
        """``_FrozenFPN`` (ResNet with frozen BatchNorm, then the pyramid)
        under JAX's auto-names ``ResNetBackbone_0`` / ``FPN_0``, on NCHW
        images, within 1e-5 of flax's: the JAX forward's teacher features
        are its ``_FrozenFPN`` of x."""
        assert set(twin["variables"]["params"]["task_net"]) == {"ResNetBackbone_0", "FPN_0"}
        assert isinstance(twin["tm"].task_net, _FrozenFPN)
        with torch.no_grad():
            out = twin["tm"].task_net(nchw(twin["x"]))
        for k in LEVELS:
            _assert_close(nhwc(out[k]), twin["ref"]["Teacher_output_features"][k], MODULE_TOL, k)

    def test_state_dict_covers_every_jax_variable(self, twin):
        """Every parameter and BatchNorm statistic, and nothing else."""
        v = twin["variables"]
        assert (sum(len(jax.tree_util.tree_leaves(v[k])) for k in ("params", "batch_stats"))
                == len(twin["tm"].state_dict()))

    def test_eval_forward_matches_jax(self, twin):
        """x_hat (and decompressedImage, the same tensor), both likelihoods,
        and the teacher's (on x) and the student's (on x_hat) P2-P6 within
        1e-4."""
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]))
        ref = twin["ref"]
        assert set(out) == set(ref)
        assert out["decompressedImage"] is out["x_hat"]
        pairs = [(out["x_hat"], ref["x_hat"], "x_hat")]
        pairs += [(out["likelihoods"][k], ref["likelihoods"][k], k) for k in "yz"]
        err = {n: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, n in pairs}
        for a, b, n in pairs:
            assert tuple(a.shape) == b.shape, n
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=n)
        err.update(assert_features_match(out, ref, FORWARD_TOL, "oj_ICM"))
        print(f"oj_ICM largest |port - JAX|: {err}")

    @pytest.mark.parametrize("wire", wires)
    def test_roundtrip_bitexact(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["port"][wire].decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape

    def test_device_wire_floats_are_the_host_wire_floats(self, twin):
        for k in ("y_hat", "x_hat"):
            assert torch.equal(twin["enc"]["device"][k], twin["enc"]["host"][k]), k

    @pytest.mark.parametrize("wire", wires)
    def test_symbols_match_jax(self, twin, wire):
        """0 y symbols differ from the JAX codec's; x_hat within the
        forward's bar of JAX's decoder's; z's grid JAX's."""
        enc, jenc = twin["enc"][wire], twin["jenc"][wire]
        flipped = np.abs(nhwc(enc["y_hat"]) - np.asarray(jenc["y_hat"])) > 0.5
        print(f"oj_ICM {wire}: y symbols that differ from JAX's: {flipped.sum()} of "
              f"{flipped.size}; nonzero: {int(np.count_nonzero(np.rint(enc['y_hat'].numpy())))}")
        assert flipped.sum() == 0
        np.testing.assert_allclose(nhwc(enc["y_hat"]), np.asarray(jenc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(enc["x_hat"].numpy(), np.asarray(twin["jdec"][wire]["x_hat"]),
                                   rtol=0, atol=FORWARD_TOL)
        assert enc["shape"] == tuple(jenc["shape"])

    @pytest.mark.parametrize("wire", wires)
    @pytest.mark.parametrize("stream", ["y", "z"])
    def test_streams_match_jax_byte_for_byte(self, twin, wire, stream):
        k = "yz".index(stream)
        got, want = twin["enc"][wire]["strings"][k], twin["jenc"][wire]["strings"][k]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"{stream} of image {b}: {len(g)} vs {len(w)} bytes"

    @pytest.mark.parametrize("wire", wires)
    def test_port_decodes_the_jax_streams(self, twin, wire):
        jenc = twin["jenc"][wire]
        dec = twin["port"][wire].decompress(jenc["strings"], tuple(jenc["shape"]))
        np.testing.assert_allclose(nhwc(dec["y_hat"]), np.asarray(jenc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(dec["x_hat"].numpy(), np.asarray(twin["jdec"][wire]["x_hat"]),
                                   rtol=0, atol=FORWARD_TOL)

    @pytest.mark.parametrize("wire", wires)
    def test_jax_decodes_the_port_streams(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["jc"][wire].decompress(enc["strings"], enc["shape"])
        np.testing.assert_allclose(np.asarray(dec["y_hat"]), nhwc(enc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(), rtol=0,
                                   atol=FORWARD_TOL)

    def test_scan_wire_is_refused(self, twin):
        """No scan wire drives oj_ICM: ``DeviceWireCodec(scan_wire=True)``
        raises. JAX's falls back to its unrolled device wire without a word
        (its ``scan_wire`` reads False after construction), where its own
        ``tests/test_device_codec.py::test_scan_wire_rejects_sliding_support``
        (``slow``) expects a ``ValueError``: a kept difference."""
        with pytest.raises(NotImplementedError, match="FasterRCNN_Coding"):
            tmodels.DeviceWireCodec(twin["tm"], scan_wire=True)
        assert JaxDeviceWireCodec(twin["jm"], twin["variables"], scan_wire=True).scan_wire is False

    def test_train_step_matches_jax(self, twin, monkeypatch):
        """One float64 step of ``DetectionICMLoss(1.0)`` and the aux loss, as
        ``tools/train_oj.py`` trains (``freeze_patterns=("task_net",)``), the
        same noise in both: the loss terms (feature_loss among them, above
        0) and every codec gradient within 1e-6 of its max; the task net's
        parameters take no gradient (their ``requires_grad`` off) and the
        step moves every codec parameter and none of the task net's
        parameters or BatchNorm statistics."""
        tm, before, ref_grads, labels, got = step_against_jax(twin, monkeypatch, "oj_ICM",
                                                               ("task_net",))
        assert got["feature_loss"] > 0
        worst = {}
        for name, p in tm.named_parameters():
            if labels[name] == "frozen":
                assert name.startswith("task_net.") and p.grad is None and not p.requires_grad
            else:
                worst[name] = _close(p.grad.numpy(), ref_grads[name], STEP_TOL, name)
        print("oj_ICM: largest gradient error relative to its max:",
              max(worst.items(), key=lambda kv: kv[1]))
        after = tm.state_dict()
        for k, v in before.items():
            assert torch.equal(after[k], v) == k.startswith("task_net."), k
