"""The port's scan wire (``DeviceWireCodec(scan_wire=True)``, plain rANS
and launch by launch on the CPU) against the JAX package's
``CharmScanWire``.

The narrow twins of ``tests/test_device_codec.py``: WACNN at N 16, M 24,
6 slices (``TINY``) and stf at embed 8, 4 slices (``test_torch_stf``'s
``NARROW``), on two 64x64 images, 4 lanes an image, parameters drawn
with numpy and carried over with ``from_jax_params``. Held: the blobs
byte for byte with JAX's (tier byte included), y_hat within 1e-5 of
JAX's, the round trip bit for bit, decoding across the two frameworks
both ways, y_hat against the port's own device wire within JAX's
distribution bar, the escape ladder at 40 N(0, 1) and 128 px, the
stacked context weights against JAX's, ``fix_escapes``' dropped padding
against JAX's ``mode="drop"``, and the wrong wires and the bfloat16
policy raising.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import _params_from_numpy as cnn_params
from test_torch_stf import NARROW as STF_NARROW
from test_torch_stf import _params_from_numpy as stf_params

from icm_tpu.coding.device_rans import fix_escapes as jax_fix_escapes
from icm_tpu.models import WACNN as JaxWACNN
from icm_tpu.models import SymmetricalTransFormer as JaxSTF
from icm_tpu.models.cnn import stack_charm_params as jax_stack
from icm_tpu.models.cnn import unstack_charm_params as jax_unstack
from icm_tpu.models.device_codec import DeviceWireCodec as JaxDeviceWireCodec
from icm_tpu_torch import models as tmodels
from icm_tpu_torch.coding import WireFormatError
from icm_tpu_torch.coding import device_rans as tdr
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.cnn import stack_charm_params, unstack_charm_params
from icm_tpu_torch.models.device_codec import _unpack_wire
from icm_tpu_torch.models.scan_codec import _esc_tier_cap
from icm_tpu_torch.nn import set_activation_dtype

torch.set_num_threads(2)

# tests/test_device_codec.py's TINY
CNN_TINY = dict(
    N=16, M=24, num_slices=6, max_support_slices=5,
    hyper_enc_widths=(24, 20, 16, 14, 12), hyper_dec_widths=(12, 14, 16, 20, 24),
    cc_widths=(16, 12, 10, 8),
)
CONFIGS = {"cnn": (JaxWACNN, CNN_TINY, cnn_params), "stf": (JaxSTF, STF_NARROW, stf_params)}
LANES = 4
# y_hat of the two frameworks: f32 sums in another order
Y_HAT_TOL = 1e-5


def _twins(name, x):
    jcls, config, draw = CONFIGS[name]
    jm = jcls(**config)
    variables = draw(jm, x, seed=1)
    tm = tmodels.create_model(name, device="cpu", **config)
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return jm, variables, tm.eval()


@pytest.fixture(scope="module", params=["cnn", "stf"])
def scan(request):
    """-> (name, x, JAX model, variables, port model, port codec, its
    debug encode, JAX codec, its debug encode)."""
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    jm, variables, tm = _twins(request.param, x)
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, scan_wire=True)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    jc = JaxDeviceWireCodec(jm, variables, lanes_per_image=LANES, scan_wire=True)
    jenc = jc.compress(jnp.asarray(x), return_debug=True)
    return dict(name=request.param, x=x, jm=jm, variables=variables, tm=tm, codec=codec,
                enc=enc, jc=jc, jenc=jenc)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stream", ["y", "z"])
def test_blobs_match_jax(scan, stream):
    k = "yz".index(stream)
    got, want = scan["enc"]["strings"][k], scan["jenc"]["strings"][k]
    assert len(got) == len(want) == 2
    for b, (g, w) in enumerate(zip(got, want)):
        n_diff = sum(p != q for p, q in zip(g, w)) + abs(len(g) - len(w))
        assert g == w, f"{stream} wire of image {b}: {n_diff} bytes differ"
    if stream == "y":
        assert {g[3] for g in got} == {WIRE_SCAN}
        assert {g[4] for g in got} == {w[4] for w in want}  # one tier byte, JAX's


def test_y_hat_matches_jax(scan):
    np.testing.assert_allclose(_nhwc(scan["enc"]["y_hat"]), np.asarray(scan["jenc"]["y_hat"]),
                               rtol=0, atol=Y_HAT_TOL)


def test_roundtrip_bitexact(scan):
    enc = scan["enc"]
    dec = scan["codec"].decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    assert dec["x_hat"].shape == scan["x"].shape


def test_port_decodes_the_jax_wire(scan):
    jenc = scan["jenc"]
    dec = scan["codec"].decompress(jenc["strings"], jenc["shape"])
    np.testing.assert_allclose(_nhwc(dec["y_hat"]), np.asarray(jenc["y_hat"]),
                               rtol=0, atol=Y_HAT_TOL)


def test_jax_decodes_the_port_wire(scan):
    enc = scan["enc"]
    dec = scan["jc"].decompress(enc["strings"], enc["shape"])
    np.testing.assert_allclose(np.asarray(dec["y_hat"]), _nhwc(enc["y_hat"]),
                               rtol=0, atol=Y_HAT_TOL)


def test_y_hat_against_the_device_wire(scan):
    """The padded first conv sums in another order than the device wire's
    per-slice one: JAX's distribution bar
    (``tests/test_device_codec.py::test_scan_wire_roundtrip_cnn``)."""
    dev = tmodels.DeviceWireCodec(scan["tm"], lanes_per_image=LANES)
    denc = dev.compress(torch.from_numpy(scan["x"]), return_debug=True)
    d = (scan["enc"]["y_hat"] - denc["y_hat"]).abs().numpy()
    assert np.mean(d > 1e-2) < 0.005, np.mean(d > 1e-2)
    assert np.median(d) < 1e-4


def test_scan_wire_decodes_once_a_slice_and_counts_no_launch(scan, monkeypatch):
    """A decompress decodes z once and y once a slice; on the CPU no
    kernel launch is counted."""
    import icm_tpu_torch.models.device_codec as dc
    import icm_tpu_torch.models.scan_codec as sc

    calls = {"z": 0, "y": 0}

    def counted(kind, fn):
        def call(*args, **kw):
            calls[kind] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(dc, "decode_lanes", counted("z", dc.decode_lanes))
    monkeypatch.setattr(sc, "decode_lanes", counted("y", sc.decode_lanes))
    before = (tdr.DECODE_LAUNCHES, tdr.ENCODE_LAUNCHES)
    enc = scan["enc"]
    scan["codec"].decompress(enc["strings"], enc["shape"])
    assert calls == {"z": 1, "y": scan["tm"].ctx_slices}
    assert (tdr.DECODE_LAUNCHES, tdr.ENCODE_LAUNCHES) == before


def test_weights_changed_in_place_are_restacked(scan):
    """An in-place weight change reaches the scan wire's stacked weights:
    the codec then encodes as a new codec on the changed model does."""
    tm = tmodels.create_model(scan["name"], device="cpu", **CONFIGS[scan["name"]][1])
    tm.load_state_dict(scan["tm"].state_dict())
    tm.eval()
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, scan_wire=True)
    x = torch.from_numpy(scan["x"])
    before = codec.compress(x, return_debug=True)
    with torch.no_grad():
        tm.cc_mean_1.Conv_0.weight.mul_(1.5)
    after = codec.compress(x, return_debug=True)
    fresh = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, scan_wire=True)
    want = fresh.compress(x, return_debug=True)
    assert not torch.equal(after["y_hat"], before["y_hat"])
    assert torch.equal(after["y_hat"], want["y_hat"])
    assert after["strings"] == want["strings"]


def test_escape_tier_ladder():
    """40 N(0, 1) images at 128 px on the narrow WACNN: a third of the
    symbols escape, more than tier 0's cap of a segment (512 symbols, cap
    64), so the encoder picks a higher tier; every blob carries it, the
    escapes fit its cap, the round trip is bit-exact, and JAX's encoder
    picks the same tier."""
    x = (40.0 * np.random.default_rng(7).standard_normal((2, 128, 128, 3))).astype(np.float32)
    jm, variables, tm = _twins("cnn", x)
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, scan_wire=True)
    enc = codec.compress(torch.from_numpy(x), return_debug=True)
    tiers = {blob[4] for blob in enc["strings"][0]}
    assert len(tiers) == 1, tiers
    tier = tiers.pop()
    assert tier > 0, "input did not stress the escape channel"
    h = w = 128 // 16
    seg = (h * w // LANES) * (CNN_TINY["M"] // CNN_TINY["num_slices"]) * 2 * LANES
    for blob in enc["strings"][0]:
        _, _, dest, _ = _unpack_wire(blob, WIRE_SCAN, skip=1)
        assert dest.shape[0] <= CNN_TINY["num_slices"] * _esc_tier_cap(seg, tier)
    dec = codec.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"])
    assert torch.equal(dec["x_hat"], enc["x_hat"])
    jc = JaxDeviceWireCodec(jm, variables, lanes_per_image=LANES, scan_wire=True)
    jenc = jc.compress(jnp.asarray(x))
    assert {blob[4] for blob in jenc["strings"][0]} == {tier}


def _port_layout(tree: dict) -> dict:
    """JAX-layout per-slice or stacked leaves -> the port's layout: a
    conv ``kernel`` (..., kH, kW, I, O) -> ``weight`` (..., O, I, kH, kW);
    float32, as ``from_jax_params`` gives them (the numpy-drawn twins'
    parameters are float64 arrays, which JAX reads as float32)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _port_layout(v)
        elif k == "kernel":
            a = np.asarray(v, np.float32)
            n = a.ndim
            out["weight"] = np.transpose(a, tuple(range(n - 4)) + (n - 1, n - 2, n - 4, n - 3))
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _assert_trees_equal(got: dict, want: dict, path=""):
    assert set(got) == set(want), (path, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g = np.asarray(got[k])
            assert g.shape == want[k].shape and np.array_equal(g, want[k]), f"{path}/{k}"


def _dims(tm):
    sc = tm.M // tm.num_slices
    return tm.num_slices, sc, tm.max_support_slices, int(tm.cc_mean_0.Conv_0.weight.shape[1])


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_stacked_context_weights_match_jax(name):
    """``stack_charm_params`` on the port's model equals JAX's on the
    same weights, layouts mapped; ``unstack_charm_params`` gives JAX's
    unstacked tree, and the port's own parameters back exactly."""
    x = np.random.default_rng(0).random((1, 64, 64, 3)).astype(np.float32)
    _, variables, tm = _twins(name, x)
    dims = _dims(tm)
    got = stack_charm_params(tm, *dims)
    want = jax_stack(variables["params"], *dims)
    _assert_trees_equal(got, _port_layout(want))
    back = unstack_charm_params(got, *dims)
    _assert_trees_equal(back, _port_layout(jax_unstack(want, *dims)))
    state = tm.state_dict()
    flat = {f"{k}.{ln}.{leaf}": t for k, layers in back.items()
            for ln, p in layers.items() for leaf, t in p.items()}
    assert len(flat) == 3 * dims[0] * 2 * (len(CONFIGS[name][1]["cc_widths"]) + 1)
    for key, t in flat.items():
        assert torch.equal(t, state[key]), key


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_from_jax_params_takes_a_charm_scan_tree(name):
    """A JAX ``scan_charm=True`` tree carries the context stacks as one
    ``charm_scan`` subtree: it converts to the state dict of the unrolled
    tree it was stacked from."""
    x = np.random.default_rng(0).random((1, 64, 64, 3)).astype(np.float32)
    _, variables, tm = _twins(name, x)
    params = jax.device_get(variables["params"])
    scanned = {k: v for k, v in params.items()
               if k.rsplit("_", 1)[0] not in ("cc_mean", "cc_scale", "lrp")}
    scanned.update(jax_stack(params, *_dims(tm)))
    # the tree of a JAX scan_charm=True model has this structure
    jcls, config, _ = CONFIGS[name]
    real = jax.eval_shape(lambda: jcls(**config, scan_charm=True).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.asarray(x), training=False))["params"]
    assert jax.tree_util.tree_map(np.shape, real) == jax.tree_util.tree_map(np.shape, scanned)
    got, want = from_jax_params(scanned), from_jax_params(params)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_fix_escapes_drops_padding_as_jax_does():
    """Padded escape positions (at or past T * lanes) are dropped, as by
    JAX's ``mode="drop"``, and the positions in the grid take their raw
    values."""
    rng = np.random.default_rng(3)
    T, lanes, E = 12, 7, 30
    vals = rng.integers(-100, 100, (T, lanes)).astype(np.int32)
    dest = rng.choice(T * lanes, E - 10, replace=False).astype(np.int32)
    dest = np.concatenate([dest, np.full(6, T * lanes, np.int32),
                           T * lanes + rng.integers(1, 50, 4).astype(np.int32)])
    raw = rng.integers(-2 ** 31, 2 ** 31 - 1, E).astype(np.int32)
    got = tdr.fix_escapes(*(torch.from_numpy(a) for a in (vals, dest, raw)))
    want = np.asarray(jax_fix_escapes(*(jnp.asarray(a) for a in (vals, dest, raw))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, vals)


@pytest.mark.parametrize("case", ["scan_into_device", "device_into_scan"])
def test_wrong_wire_raises(scan, case):
    tm, x = scan["tm"], torch.from_numpy(scan["x"])
    dev = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES)
    if case == "scan_into_device":
        decoder, enc = dev, scan["enc"]
        match = "expects device-v2"
    else:
        decoder, enc = scan["codec"], dev.compress(x)
        match = "expects scan-wire"
    with pytest.raises(WireFormatError, match=match):
        decoder.decompress(enc["strings"], enc["shape"])


def test_scan_wire_raises_under_the_bf16_policy(scan):
    """JAX's scan wire raises under its bfloat16 policy (its context
    convolutions mix bfloat16 and float32); the port's refuses the policy
    at construction and at each call."""
    set_activation_dtype(torch.bfloat16)
    try:
        with pytest.raises(ValueError, match="float32 only"):
            tmodels.DeviceWireCodec(scan["tm"], lanes_per_image=LANES, scan_wire=True)
        with pytest.raises(ValueError, match="float32 only"):
            scan["codec"].compress(torch.from_numpy(scan["x"]))
        enc = scan["enc"]
        with pytest.raises(ValueError, match="float32 only"):
            scan["codec"].decompress(enc["strings"], enc["shape"])
    finally:
        set_activation_dtype(None)
