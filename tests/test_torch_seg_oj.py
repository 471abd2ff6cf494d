"""``seg_oj_ICM`` (``MaskedRCNN_FasterRCNN_Coding``: oj_ICM's machine layer
and a segmentation layer on ``cat(x_hat, x)`` added back to x_hat) and its
``SegOjCodec``: icm_tpu_torch against the JAX package.

The narrow twin of ``test_torch_oj.py`` (``TINY_CODEC``, ``task_layers (1,
1, 1, 1)``, two 64 x 64 images, the codec drawn as the CRC twins', the task
net as a task net). One JAX ``SegOjCodec(wire="device", scan_wire=True)``
serves its three wires (``test_torch_stf_family.OnWire`` sets ``wire`` and
``scan_wire`` at each call), so that they share its compiled functions;
the port's codecs take its tables.

Held here: every JAX variable in the port's state dict; the eval forward
(x_hat, machine_x_hat, both layers' likelihoods, the teacher's and the
student's P2-P6) within 1e-4; on the host, device and scan wires the round
trip bit for bit, both layers' y symbols JAX's, the four streams byte for
byte with JAX's (the scan wire's tier byte included) and decoding across
the two frameworks both ways; the device wire's floats the host wire's,
the scan wire's latents within JAX's bar of the device wire's; the
bottleneck keys JAX's (``seg_entropy_bottleneck``); one float64 step of
``DetectionICMLoss`` under ``train_patterns=("seg",)`` and
``freeze_patterns=("task_net",)`` (``tools/train_seg_oj.py``'s) against
JAX autodiff, where only the ``seg*`` parameters take gradients; the
bfloat16 policy's eval forward against JAX's float32 one at
``tests/test_bf16.py``'s bars (bfloat16 against float32, on weights of the
JAX init's distributions), the task net in float32.

JAX's debug compress gives its x_hat unclipped and its decompress clips
it; the port's give it in [0, 1] on both sides, so JAX's debug x_hat is
held here clipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import BF16, _assert_bf16_close, _bpp
from test_torch_cnn_codec import CROSS_TOL
from test_torch_crc import FORWARD_TOL, init_like
from test_torch_oj import (STEP_TOL, TINY, assert_features_match, jax_eval, make_twin,
                           nhwc, step_against_jax)
from test_torch_stf_family import OnWire, port_tables
from test_torch_train import _close

from icm_tpu.models.crc_codec import SegOjCodec as JaxSegOjCodec
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.crc_codec import SegOjCodec

torch.set_num_threads(2)

# the wires: (the codec's wire, scan_wire)
WIRES = {"host": ("host", False), "device": ("device", False), "scan": ("device", True)}
LATENTS = ("y_hat", "seg_y_hat")
STREAMS = ("y", "z", "seg_y", "seg_z")
# the scan wire against the device wire: JAX's bar (tests/test_crc.py)
SCAN_SHARE, SCAN_MEDIAN = 0.005, 1e-4


def pytest_generate_tests(metafunc):
    if "wire" in metafunc.fixturenames:
        metafunc.parametrize("wire", list(WIRES))


@pytest.fixture(scope="module")
def twin():
    jm, variables, tm, x = make_twin("seg_oj_ICM")
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    jcodec = JaxSegOjCodec(jm, variables, wire="device", scan_wire=True)
    jc = {w: OnWire(jcodec, *WIRES[w]) for w in WIRES}
    tables = port_tables(jcodec.tables)
    port = {w: SegOjCodec(tm, tables=tables, wire=wire, scan_wire=scan)
            for w, (wire, scan) in WIRES.items()}
    ref, jax_forward = jax_eval(jm, variables, x)
    return dict(jm=jm, variables=variables, tm=tm, x=x, jc=jc, port=port, ref=ref,
                jax_forward=jax_forward,
                jenc={w: c.compress(xj, return_debug=True) for w, c in jc.items()},
                enc={w: c.compress(xt, return_debug=True) for w, c in port.items()})


def decompress(codec, enc):
    return codec.decompress(enc["strings"], tuple(enc["shape"]), tuple(enc["seg_shape"]))


def test_state_dict_covers_every_jax_variable(twin):
    v = twin["variables"]
    assert (sum(len(jax.tree_util.tree_leaves(v[k])) for k in ("params", "batch_stats"))
            == len(twin["tm"].state_dict()))


def test_bottleneck_keys_are_jax_keys(twin):
    """The segmentation layer's bottleneck is ``seg_entropy_bottleneck`` in
    the model's ``eb_dict`` and the codec's tables, as in JAX (``stf13``'s
    is ``entropy_bottleneck_seg``)."""
    keys = ["entropy_bottleneck", "seg_entropy_bottleneck"]
    assert list(twin["tm"].eb_dict()) == keys
    assert sorted(twin["jc"]["host"].tables.bottlenecks) == keys
    assert sorted(tmodels.build_codec_tables(twin["tm"]).bottlenecks) == keys


def test_eval_forward_matches_jax(twin):
    """x_hat (decompressedImage, the same tensor), machine_x_hat, both
    layers' likelihoods and the teacher's and the student's (on the machine
    layer's x_hat) P2-P6 within 1e-4."""
    with torch.no_grad():
        out = twin["tm"](torch.from_numpy(twin["x"]))
    ref = twin["ref"]
    assert set(out) == set(ref)
    assert out["decompressedImage"] is out["x_hat"]
    pairs = [(out[k], ref[k], k) for k in ("x_hat", "machine_x_hat")]
    pairs += [(out[g][k], ref[g][k], f"{g} {k}") for g in ("likelihoods", "machine_likelihoods")
              for k in "yz"]
    err = {n: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, n in pairs}
    for a, b, n in pairs:
        assert tuple(a.shape) == b.shape, n
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL, atol=FORWARD_TOL,
                                   err_msg=n)
    err.update(assert_features_match(out, ref, FORWARD_TOL, "seg_oj_ICM"))
    print(f"seg_oj_ICM largest |port - JAX|: {err}")


def test_roundtrip_bitexact(twin, wire):
    enc = twin["enc"][wire]
    dec = decompress(twin["port"][wire], enc)
    for k in LATENTS + ("x_hat",):
        assert torch.equal(dec[k], enc[k]), k
    assert dec["x_hat"].shape == twin["x"].shape
    assert float(dec["x_hat"].min()) >= 0 and float(dec["x_hat"].max()) <= 1


def test_device_wire_floats_are_the_host_wire_floats(twin):
    host, dev = twin["enc"]["host"], twin["enc"]["device"]
    for k in LATENTS + ("x_hat",):
        assert torch.equal(dev[k], host[k]), k


def test_symbols_match_jax(twin, wire):
    """0 symbols of either layer differ from the JAX codec's, and each layer
    codes nonzero ones; x_hat within the forward's bar of JAX's (clipped);
    the z grids JAX's."""
    enc, jenc = twin["enc"][wire], twin["jenc"][wire]
    for k in LATENTS:
        port_y, jax_y = nhwc(enc[k]), np.asarray(jenc[k])
        flipped = np.abs(port_y - jax_y) > 0.5
        print(f"seg_oj_ICM {wire}: {k} symbols that differ from JAX's: {flipped.sum()} of "
              f"{flipped.size}; nonzero {int(np.count_nonzero(np.rint(port_y)))}")
        assert flipped.sum() == 0 and np.rint(port_y).any(), k
        np.testing.assert_allclose(port_y, jax_y, rtol=0, atol=CROSS_TOL, err_msg=k)
    np.testing.assert_allclose(enc["x_hat"].numpy(), np.clip(np.asarray(jenc["x_hat"]), 0, 1),
                               rtol=0, atol=FORWARD_TOL)
    for k in ("shape", "seg_shape"):
        assert enc[k] == tuple(jenc[k]), k


@pytest.mark.parametrize("stream", STREAMS)
def test_streams_match_jax_byte_for_byte(twin, wire, stream):
    """Each of [y, z, seg_y, seg_z], image by image; on the scan wire each
    layer's y with its framing and tier byte."""
    k = STREAMS.index(stream)
    got, want = twin["enc"][wire]["strings"][k], twin["jenc"][wire]["strings"][k]
    assert len(twin["enc"][wire]["strings"]) == len(STREAMS)
    assert len(got) == len(want) == 2
    for b, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{stream} of image {b}: {len(g)} vs {len(w)} bytes"
    if wire == "scan" and stream in ("y", "seg_y"):
        assert all(g[3] == WIRE_SCAN for g in got)


def _decodes(dec, enc, jax_side: bool):
    """Each latent within CROSS_TOL of the encoder's (a wrong symbol shows
    as a jump of 1 or more), x_hat within the forward's bar."""
    for k in LATENTS:
        got = np.asarray(dec[k]) if jax_side else nhwc(dec[k])
        want = nhwc(enc[k]) if jax_side else np.asarray(enc[k])
        np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_TOL, err_msg=k)
    np.testing.assert_allclose(np.asarray(dec["x_hat"]), np.clip(np.asarray(enc["x_hat"]), 0, 1),
                               rtol=0, atol=FORWARD_TOL)


def test_port_decodes_the_jax_streams(twin, wire):
    jenc = twin["jenc"][wire]
    _decodes(decompress(twin["port"][wire], jenc), jenc, jax_side=False)


def test_jax_decodes_the_port_streams(twin, wire):
    enc = twin["enc"][wire]
    _decodes(decompress(twin["jc"][wire], enc), enc, jax_side=True)


def test_scan_latents_against_the_device_wire(twin):
    """The scan wire's padded first conv sums in another order: each latent
    within JAX's bar of the device wire's (under 0.5% of elements more than
    1e-2 apart, median under 1e-4)."""
    for k in LATENTS:
        d = np.abs(twin["enc"]["scan"][k].numpy() - twin["enc"]["device"][k].numpy())
        print(f"seg_oj_ICM scan vs device wire {k}: {np.mean(d > 1e-2):.4%} past 1e-2, "
              f"median {np.median(d):.2e}")
        assert np.mean(d > 1e-2) < SCAN_SHARE and np.median(d) < SCAN_MEDIAN, k


def test_train_step_matches_jax(twin, monkeypatch):
    """One float64 step as ``tools/train_seg_oj.py`` trains
    (``freeze_patterns=("task_net",)``, ``train_patterns=("seg",)``,
    ``DetectionICMLoss(1.0)`` over the segmentation layer's rate), the same
    noise in both: the loss terms within 1e-6, the ``seg*`` gradients within
    1e-6 of their max; no other parameter takes a gradient or moves. The
    feature term (above 0) reads the machine layer's x_hat only, so it
    reaches no trainable parameter, in JAX as here."""
    tm, before, ref_grads, labels, got = step_against_jax(
        twin, monkeypatch, "seg_oj_ICM", ("task_net",), ("seg",))
    assert got["feature_loss"] > 0
    trained = {n for n, lab in labels.items() if lab != "frozen"}
    assert trained == {n for n, _ in tm.named_parameters() if n.startswith("seg_")}
    worst = {}
    for name, p in tm.named_parameters():
        if name in trained:
            worst[name] = _close(p.grad.numpy(), ref_grads[name], STEP_TOL, name)
        else:
            assert p.grad is None and not p.requires_grad, name
    print("seg_oj_ICM: largest gradient error relative to its max:",
          max(worst.items(), key=lambda kv: kv[1]))
    after = tm.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v) == (not k.startswith("seg_")), k


def test_each_optimizer_sets_what_trains():
    """Building an optimizer sets every parameter's ``requires_grad`` to
    whether its patterns train it, both ways: after a segmentation-only
    optimizer (``tools/train_seg_oj.py``'s patterns) one that freezes the
    task net alone trains the machine layer again."""
    tm = tmodels.create_model("seg_oj_ICM", device="cpu", **TINY)
    names = [n for n, _ in tm.named_parameters()]
    ttrain.make_optimizer(tm, freeze_patterns=("task_net",), train_patterns=("seg",))
    trains = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert trains == {n for n in names if n.startswith("seg_")}
    ttrain.make_optimizer(tm, freeze_patterns=("task_net",))
    trains = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert trains == {n for n in names if not n.startswith("task_net.")}
    assert trains > {n for n in names if n.startswith(("g_a.", "coder."))}


def test_eval_forward_bf16_matches_jax_f32(twin):
    """The bfloat16 policy's eval forward against JAX's float32 one (the
    twin's compiled forward) and the port's float32 one, at
    ``tests/test_bf16.py``'s bars (bfloat16 against float32 through the
    model: mean |x_hat difference| under 0.01, bpp within 5%), on weights of
    the JAX init's distributions (``test_torch_crc.init_like``: with the
    twin's draws bfloat16 strays 0.19 from float32 in mean |x_hat|), x_hat
    and machine_x_hat bfloat16, the likelihoods float32. The task net reads
    no policy (JAX's ``tasks/`` read none): its features are float32, the
    teacher's the float32 forward's bit for bit and the student's those of
    the task net run without the policy on the bfloat16 machine_x_hat."""
    x = twin["x"]
    variables = init_like(twin["variables"])
    ref = twin["jax_forward"](variables, jnp.asarray(x))
    tm = tmodels.create_model("seg_oj_ICM", device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    tm.eval()
    n_px = x.shape[0] * x.shape[1] * x.shape[2]
    xs = torch.from_numpy(x)
    try:
        with torch.no_grad():
            f32 = tm(xs)
            tnn.set_activation_dtype(BF16)
            out = tm(xs)
    finally:
        tnn.set_activation_dtype(None)

    def bpp(o):
        return sum(_bpp({k: np.asarray(v, np.float32) for k, v in o[g].items()}, n_px)
                   for g in ("likelihoods", "machine_likelihoods"))

    assert out["x_hat"].dtype == out["machine_x_hat"].dtype == BF16
    assert {v.dtype for g in ("likelihoods", "machine_likelihoods")
            for v in out[g].values()} == {torch.float32}
    for key in ("x_hat", "machine_x_hat"):
        _assert_bf16_close(f"seg_oj_ICM {key}: port bf16 against JAX f32", out[key].float(),
                           bpp(out), ref[key], bpp(ref))
        _assert_bf16_close(f"seg_oj_ICM {key}: port bf16 against port f32", out[key].float(),
                           bpp(out), f32[key], bpp(f32))
    with torch.no_grad():
        student = tm.task_net(out["machine_x_hat"].permute(0, 3, 1, 2).contiguous().float())
    for k in ("p2", "p3", "p4", "p5", "p6"):
        teacher = out["Teacher_output_features"][k]
        assert teacher.dtype == out["Student_output_features"][k].dtype == torch.float32, k
        assert torch.equal(teacher, f32["Teacher_output_features"][k]), k
        assert torch.equal(out["Student_output_features"][k], student[k].permute(0, 2, 3, 1)), k
