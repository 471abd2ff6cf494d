"""The zigzag family's scan wire, training forwards and bfloat16 policy:
icm_tpu_torch against the JAX package.

The narrow twins of ``test_torch_stf_family.py`` (``TWINS``: stf5like to
stf8like, two 64 x 64 images, JAX parameters drawn with numpy and carried
over with ``from_jax_params``). Each twin's tests run in files of their
own (``test_torch_stf_family_scan_*.py`` for :class:`FamilyScanTwin`,
``test_torch_stf_family_bf16_*.py`` for :class:`FamilyBf16Twin`), so
that the suite's workers run the twins side by side; this file holds the
classes and the family's tests that need no JAX twin.

:class:`FamilyScanTwin` holds, against the JAX package's
``ZigzagSwinScanWire`` (``DeviceWireCodec(scan_wire=True)``, 4 lanes an
image, the JAX codec's tables): the blobs byte for byte, tier byte
included; y_hat within 1e-5; the round trip bit for bit; decoding across
the two frameworks both ways; y_hat against the port's own device wire
within JAX's distribution bar; one decode a slice; a weight changed in
place restacked; the wrong wires and the bfloat16 policy raising. Then
the stacked context weights against JAX's ``stack_zigzag_params`` bit
for bit, ``from_jax_params`` of a ``zigzag_scan`` tree, the
``scan_charm=True`` eval forward within 1e-5, and one training step of
each forward (stochastic depth 0: the masks cannot come from one
generator on both sides) against JAX autodiff in float64: loss terms within 1e-5,
each gradient within 1e-4 of its max (``test_torch_train.py``'s bars).

The training steps are held against JAX's step in float64 (see
:meth:`FamilyScanTwin.test_train_step_matches_jax`). Uniform noise is
replayed into both sides (``test_torch_train._replay``).
JAX's ``scan_charm=True`` forward traces its step once under ``nn.scan``
(and once more to build it), so every slice adds the same noise array;
the port's per-slice forward is handed that array for each slice.

:class:`FamilyBf16Twin` holds the port under ``set_activation_dtype(
torch.bfloat16)`` against JAX's family under its bfloat16 policy, at
``tests/test_bf16.py``'s bars (``test_torch_bf16.py``): the eval forward
and one training step of both forwards, and both wires' round trips,
with under 2% of y symbols differing from JAX's bfloat16 codecs and
x_hat within 0.01 of its.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import (BF16, BPP_RTOL, SYMBOL_SHARE_TOL, XHAT_MEAN_TOL,
                             _assert_bf16_close, _bpp, _dense_kernels_as_initialized)
from test_torch_cnn_codec import JaxHostWire
from test_torch_stf_family import TINY_SWIN, TWINS, make_twin, port_tables
from test_torch_train import _close, _replay

from icm_tpu import nn as jnn
from icm_tpu.models import ZigzagSwinCodec as JaxZigzag
from icm_tpu.models.device_codec import DeviceWireCodec as JaxDeviceWireCodec
from icm_tpu.models.stf_family import stack_zigzag_params as jax_stack
from icm_tpu.models.stf_family import unstack_zigzag_params as jax_unstack
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.coding import WireFormatError
from icm_tpu_torch.coding import device_rans as tdr
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.stf_family import stack_zigzag_params, unstack_zigzag_params

torch.set_num_threads(2)

LANES = 4
# y_hat of the two frameworks: f32 sums in another order
Y_HAT_TOL = 1e-5
# f32 training on both sides, sums in another order (test_torch_train.py)
TERMS_TOL, GRAD_TOL = 1e-5, 1e-4


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def _port_model(name: str, **overrides):
    preset, ctx = TWINS[name]
    return tmodels.create_model(preset, device="cpu", **{**TINY_SWIN, **ctx, **overrides})


def _jax_model(name: str, **overrides):
    return JaxZigzag(**{**TINY_SWIN, **TWINS[name][1], **overrides})


def _noise(tm, x, scan: bool, seed: int = 5):
    """-> (the JAX side's noise arrays, the port's): z's, then a slice's
    (NHWC), one for every slice, or (``scan``) one for them all."""
    rng = np.random.default_rng(seed)
    n = x.shape[1] // 16 // tm.spatial_number
    z = rng.uniform(-0.5, 0.5, (TINY_SWIN["hyper_enc_widths"][-1], 1, 2)).astype(np.float32)

    def draw():
        return rng.uniform(-0.5, 0.5, (x.shape[0], n, n, tm.slice_ch)).astype(np.float32)

    if scan:
        s = draw()
        return [z, s, s], [z] + [s] * tm.ctx_slices
    ys = [draw() for _ in range(tm.ctx_slices)]
    return [z] + ys, [z] + ys


def _jax_tree_to_port(tree: dict, i: int) -> dict:
    """Slice i of a stacked JAX subtree in the port's layout, as flat keys."""
    return from_jax_params(jax.tree_util.tree_map(lambda a: np.asarray(a)[i], tree))


def _f64_port_params(tree: dict, model) -> dict:
    """A float64 JAX parameter tree (a ``zigzag_scan`` one unstacked with
    ``model``) in the port's names and layouts, kept float64
    (``from_jax_params`` gives float32)."""
    from icm_tpu_torch.convert import _convert, _walk

    tree = dict(tree)
    if "zigzag_scan" in tree:
        tree.update(_flat_port_nested(unstack_zigzag_params(
            {"zigzag_scan": tree.pop("zigzag_scan")}, model)))
    out = {}
    for path, value in _walk(tree):
        leaf, arr = _convert(path, np.asarray(value))
        out[".".join(path[:-1] + (leaf,))] = np.asarray(arr, np.float64)
    return out


def _flat_port_nested(tree: dict) -> dict:
    """Tensor leaves -> numpy leaves (float64 kept), the nesting kept."""
    return {k: _flat_port_nested(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _flat_port(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class FamilyScanTwin:
    """The scan-wire and training tests of one twin; a file per twin
    subclasses it as ``Test<Twin>Scan`` with ``name`` set."""

    name = ""

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x = make_twin(self.name)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        jc = JaxDeviceWireCodec(jm, variables, lanes_per_image=LANES, scan_wire=True)
        tables = port_tables(jc.tables)
        codec = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, scan_wire=True, tables=tables)
        dev = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, tables=tables)
        return dict(jm=jm, variables=variables, tm=tm, x=x, jc=jc,
                    jenc=jc.compress(xj, return_debug=True), tables=tables, codec=codec,
                    enc=codec.compress(xt, return_debug=True), dev=dev,
                    dev_enc=dev.compress(xt, return_debug=True))

    # --- the scan wire -----------------------------------------------------------
    @pytest.mark.parametrize("stream", ["y", "z"])
    def test_scan_blobs_match_jax(self, twin, stream):
        k = "yz".index(stream)
        got, want = twin["enc"]["strings"][k], twin["jenc"]["strings"][k]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            n_diff = sum(p != q for p, q in zip(g, w)) + abs(len(g) - len(w))
            assert g == w, f"{stream} wire of image {b}: {n_diff} bytes differ"
        if stream == "y":
            assert {g[3] for g in got} == {WIRE_SCAN}
            assert {g[4] for g in got} == {w[4] for w in want}  # one tier byte, JAX's

    def test_scan_y_hat_matches_jax(self, twin):
        np.testing.assert_allclose(_nhwc(twin["enc"]["y_hat"]), np.asarray(twin["jenc"]["y_hat"]),
                                   rtol=0, atol=Y_HAT_TOL)

    def test_scan_roundtrip_bitexact(self, twin):
        enc = twin["enc"]
        dec = twin["codec"].decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"])
        assert torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape

    def test_port_decodes_the_jax_scan_wire(self, twin):
        jenc = twin["jenc"]
        dec = twin["codec"].decompress(jenc["strings"], jenc["shape"])
        np.testing.assert_allclose(_nhwc(dec["y_hat"]), np.asarray(jenc["y_hat"]),
                                   rtol=0, atol=Y_HAT_TOL)

    def test_jax_decodes_the_port_scan_wire(self, twin):
        enc = twin["enc"]
        dec = twin["jc"].decompress(enc["strings"], enc["shape"])
        np.testing.assert_allclose(np.asarray(dec["y_hat"]), _nhwc(enc["y_hat"]),
                                   rtol=0, atol=Y_HAT_TOL)

    def test_scan_y_hat_against_the_device_wire(self, twin):
        """The padded first conv sums in another order than the device
        wire's per-slice one: JAX's distribution bar
        (``tests/test_stf_family.py::test_scan_wire_roundtrip``)."""
        d = (twin["enc"]["y_hat"] - twin["dev_enc"]["y_hat"]).abs().numpy()
        assert np.mean(d > 1e-2) < 0.005, np.mean(d > 1e-2)
        assert np.median(d) < 1e-4

    def test_scan_wire_decodes_once_a_slice_and_counts_no_launch(self, twin, monkeypatch):
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
        enc = twin["enc"]
        twin["codec"].decompress(enc["strings"], enc["shape"])
        assert calls == {"z": 1, "y": twin["tm"].ctx_slices}
        assert (tdr.DECODE_LAUNCHES, tdr.ENCODE_LAUNCHES) == before

    def test_scan_weights_changed_in_place_are_restacked(self, twin):
        """A weight changed in place reaches the padded convolutions and the
        refiners the chain reads: the codec then encodes as a new codec on
        the changed model does."""
        tm = _port_model(self.name)
        tm.load_state_dict(twin["tm"].state_dict())
        tm.eval()
        x = torch.from_numpy(twin["x"])
        codec = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, scan_wire=True,
                                        tables=twin["tables"])
        before = codec.compress(x, return_debug=True)
        with torch.no_grad():
            tm.cc_mean_1.Conv_0.weight.mul_(1.5)
            tm.mu_refine_1.stage0.block0.mlp.Dense_1.weight.mul_(2.0)
        after = codec.compress(x, return_debug=True)
        fresh = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, scan_wire=True,
                                        tables=twin["tables"])
        want = fresh.compress(x, return_debug=True)
        assert not torch.equal(after["y_hat"], before["y_hat"])
        assert torch.equal(after["y_hat"], want["y_hat"])
        assert after["strings"] == want["strings"]

    @pytest.mark.parametrize("case", ["scan_into_device", "device_into_scan"])
    def test_wrong_wire_raises(self, twin, case):
        if case == "scan_into_device":
            decoder, enc, match = twin["dev"], twin["enc"], "expects device-v2"
        else:
            decoder, enc, match = twin["codec"], twin["dev_enc"], "expects scan-wire"
        with pytest.raises(WireFormatError, match=match):
            decoder.decompress(enc["strings"], enc["shape"])

    def test_scan_wire_raises_under_the_bf16_policy(self, twin):
        """As JAX's scan wire, the family's runs in float32 only: the policy
        is refused at construction and at each call."""
        tnn.set_activation_dtype(BF16)
        try:
            with pytest.raises(ValueError, match="float32 only"):
                tmodels.DeviceWireCodec(twin["tm"], lanes_per_image=LANES, scan_wire=True)
            with pytest.raises(ValueError, match="float32 only"):
                twin["codec"].compress(torch.from_numpy(twin["x"]))
            enc = twin["enc"]
            with pytest.raises(ValueError, match="float32 only"):
                twin["codec"].decompress(enc["strings"], enc["shape"])
        finally:
            tnn.set_activation_dtype(None)

    # --- stacked weights and JAX's scan_charm trees ---------------------------------
    def test_stacked_weights_match_jax(self, twin):
        """``stack_zigzag_params`` on the port's model equals JAX's on the
        same weights, slice by slice in the port's layout, bit for bit;
        ``unstack_zigzag_params`` gives the port's own parameters back, and
        JAX's unstacked tree."""
        tm, params = twin["tm"], jax.device_get(twin["variables"]["params"])
        got = stack_zigzag_params(tm, tm)["zigzag_scan"]
        want = jax_stack(dict(params), twin["jm"])["zigzag_scan"]
        assert set(got) == set(want)
        for group, tree in want.items():
            for i in range(tm.ctx_slices):
                port_i = _flat_port({k: v[i] for k, v in _flat_port(got[group]).items()})
                jax_i = _jax_tree_to_port(tree, i)
                assert set(port_i) == set(jax_i), group
                for key, t in jax_i.items():
                    assert torch.equal(port_i[key], t), (group, i, key)
        back = _flat_port(unstack_zigzag_params({"zigzag_scan": got}, tm))
        state = tm.state_dict()
        context = {k for k in state if k.split(".")[0].rsplit("_", 1)[0]
                   in ("cc_mean", "cc_scale", "lrp", "mu_refine", "sigma_refine", "lrp_refine")}
        assert set(back) == context
        for key in context:
            assert torch.equal(back[key], state[key]), key
        jax_back = from_jax_params(jax_unstack(want, twin["jm"]))
        for key, t in jax_back.items():
            assert torch.equal(t, state[key]), key

    def test_from_jax_params_takes_a_zigzag_scan_tree(self, twin):
        """The tree of a JAX ``scan_charm=True`` model (its structure from
        ``jax.eval_shape``) converts, given the model, to the state dict of
        the unrolled tree it was stacked from."""
        params = jax.device_get(twin["variables"]["params"])
        scanned = jax_stack(dict(params), twin["jm"])
        real = jax.eval_shape(lambda: _jax_model(self.name, scan_charm=True).init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
            jnp.asarray(twin["x"]), training=False))["params"]
        assert (jax.tree_util.tree_map(np.shape, dict(real))
                == jax.tree_util.tree_map(np.shape, scanned))
        got, want = from_jax_params(scanned, model=twin["tm"]), from_jax_params(params)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key

    # --- the two training forwards ------------------------------------------------
    def test_scan_charm_eval_forward_matches_jax(self, twin):
        """``scan_charm=True`` without a generator, against JAX's scanned
        eval forward on the stacked weights: x_hat and the likelihoods
        within 1e-5."""
        params = jax.device_get(twin["variables"]["params"])
        js = _jax_model(self.name, scan_charm=True)
        ref = jax.jit(lambda p, a: js.apply({"params": p}, a, training=False))(
            jax_stack(dict(params), twin["jm"]), jnp.asarray(twin["x"]))
        tm = _port_model(self.name, scan_charm=True)
        tm.load_state_dict(twin["tm"].state_dict())
        with torch.no_grad():
            out = tm.eval()(torch.from_numpy(twin["x"]))
        for got, want in ((out["x_hat"], ref["x_hat"]),
                          (out["likelihoods"]["y"], ref["likelihoods"]["y"]),
                          (out["likelihoods"]["z"], ref["likelihoods"]["z"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("forward", ["unrolled", "scan_charm"])
    def test_train_step_matches_jax(self, twin, forward, monkeypatch):
        """One training step of the forward at stochastic depth 0, the port
        and JAX both in float64 (``jax.enable_x64``: the JAX package keeps
        float64 through its entropy models for such parity runs), the same
        noise in both: loss terms within 1e-5, every gradient within 1e-4
        of its max; JAX's ``scan_charm`` gradients (of the stacked tree)
        unstacked. In float32 these gradients are no sharper than the bar:
        the twins' last slices carry rounding amplified along the slice
        chain, and JAX's own float32 gradients stray from its float64 ones
        by up to 1.3e-4 of their max (stf6like), the port's by up to 1e-4;
        in float64 the two differ by up to 1.1e-5 (float32 inside each
        package's attention and constants)."""
        scan = forward == "scan_charm"
        x = twin["x"]
        params = jax.device_get(twin["variables"]["params"])
        jm = _jax_model(self.name, drop_path_rate=0.0, scan_charm=scan)
        tm = _port_model(self.name, drop_path_rate=0.0, scan_charm=scan)
        tm.load_state_dict(twin["tm"].state_dict())
        if scan:
            params = jax_stack(dict(params), twin["jm"])
        tm = tm.double()
        jax_noise, port_noise = _noise(tm, x, scan)
        tr, jr = _replay(monkeypatch, [a.astype(np.float64) for a in jax_noise])
        tr.noise = [a.astype(np.float64) for a in port_noise]
        key = jax.random.PRNGKey(0)
        x64 = x.astype(np.float64)

        def loss_fn(p):
            out = jm.apply({"params": p}, jnp.asarray(x64), training=True,
                           rngs={"noise": key, "dropout": key})
            rd = JaxRD(0.01)(out, jnp.asarray(x64))
            aux = jm.apply({"params": p}, method=jm.aux_loss)
            return rd["loss"] + aux, {**rd, "aux_loss": aux}

        # JAX's prefix-support scan step mixes int32 and literal indices in
        # one dynamic_update_slice, which x64 makes int64: give them one type
        update = jax.lax.dynamic_update_slice
        monkeypatch.setattr(jax.lax, "dynamic_update_slice", lambda a, b, idx: update(
            a, b, tuple(jnp.asarray(i, jnp.int32) for i in idx)))
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
            (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
            ref_m, ref_g = jax.device_get((ref_m, ref_g))
        assert {np.asarray(g).dtype for g in jax.tree_util.tree_leaves(ref_g)} == {
            np.dtype(np.float64)}
        assert jr.i == (3 if scan else len(jax_noise)), jr.i

        tm.train()
        out = tm(torch.from_numpy(x64), generator=torch.Generator())
        assert out["x_hat"].dtype == torch.float64
        rd = ttrain.RateDistortionLoss(0.01)(out, torch.from_numpy(x64))
        aux = tm.aux_loss()
        (rd["loss"] + aux).backward()
        assert tr.i == len(port_noise)
        for k, v in {**rd, "aux_loss": aux}.items():
            _close(v.item(), ref_m[k], TERMS_TOL, k)
        ref_grads = _f64_port_params(ref_g, tm)
        assert set(ref_grads) == {n for n, _ in tm.named_parameters()}
        worst = {name: _close(p.grad.numpy(), ref_grads[name], GRAD_TOL, name)
                 for name, p in tm.named_parameters()}
        print(f"{self.name} {forward}: largest gradient error relative to its max:",
              max(worst.items(), key=lambda kv: kv[1]))


class FamilyBf16Twin:
    """The bfloat16 policy's tests of one twin; a file per twin subclasses
    it as ``Test<Twin>Bf16`` with ``name`` set. The dense kernels take the
    JAX package's own init (``test_torch_bf16.py``), stochastic depth 0."""

    name = ""

    @pytest.fixture(autouse=True)
    def _reset_policies(self):
        yield
        jnn.set_activation_dtype(None)
        tnn.set_activation_dtype(None)

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, _, x = make_twin(self.name)
        params = _dense_kernels_as_initialized(jax.device_get(variables["params"]), 2)
        tm = _port_model(self.name, drop_path_rate=0.0)
        tm.load_state_dict(from_jax_params(params), strict=True)
        return dict(jm=jm, params=params, tm=tm.eval(), x=x)

    def _models(self, twin, scan: bool):
        """-> (JAX model, its params, the port's model) of the forward."""
        jm = _jax_model(self.name, drop_path_rate=0.0, scan_charm=scan)
        params = jax_stack(dict(twin["params"]), twin["jm"]) if scan else twin["params"]
        tm = _port_model(self.name, drop_path_rate=0.0, scan_charm=scan)
        tm.load_state_dict(twin["tm"].state_dict())
        return jm, params, tm.eval()

    @pytest.mark.parametrize("forward", ["unrolled", "scan_charm"])
    def test_eval_forward_bf16_matches_jax_bf16(self, twin, forward):
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
        assert out["x_hat"].dtype == torch.float32  # to_rgb has no dtype, as in JAX
        bpp = _bpp({k: v.numpy() for k, v in out["likelihoods"].items()}, n_px)
        _assert_bf16_close(f"{self.name} {forward} port bf16 against JAX bf16", out["x_hat"],
                           bpp, ref["x_hat"], _bpp(ref["likelihoods"], n_px))
        _assert_bf16_close(f"{self.name} {forward} port bf16 against port f32", out["x_hat"],
                           bpp, f32["x_hat"],
                           _bpp({k: v.numpy() for k, v in f32["likelihoods"].items()}, n_px))

    @pytest.mark.parametrize("forward", ["unrolled", "scan_charm"])
    def test_train_step_bf16_matches_jax_bf16(self, twin, forward, monkeypatch):
        """One training step under the policy, the same noise in both:
        float32 gradients on float32 masters, all finite; loss, bpp and MSE
        within 5% of JAX's bfloat16 training forward and mean |x_hat
        difference| under 0.01; the aux loss within 1e-5."""
        scan = forward == "scan_charm"
        jm, params, tm = self._models(twin, scan)
        x = twin["x"]
        jax_noise, port_noise = _noise(tm, x, scan)
        tr, jr = _replay(monkeypatch, jax_noise)
        tr.noise = port_noise
        key = jax.random.PRNGKey(0)
        jnn.set_activation_dtype(jnp.bfloat16)

        def terms(p):
            out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                           rngs={"noise": key, "dropout": key})
            rd = JaxRD(0.01)(out, jnp.asarray(x))
            return {**rd, "aux_loss": jm.apply({"params": p}, method=jm.aux_loss)}, out["x_hat"]

        ref_m, ref_x_hat = jax.jit(terms)(params)

        tnn.set_activation_dtype(BF16)
        state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 1.0))
        seen = {}
        handle = tm.register_forward_hook(
            lambda m, a, out: seen.update(x_hat=out["x_hat"].detach()))
        metrics = ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))(
            state, torch.from_numpy(x), torch.Generator())
        handle.remove()
        assert tr.i == len(port_noise)
        grads = [p.grad for p in tm.parameters()]
        assert {g.dtype for g in grads} == {torch.float32}
        assert all(torch.isfinite(g).all() for g in grads)
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
        device wire: bit-exact, the device wire's y_hat the host wire's;
        mean |x_hat difference| under 0.01 against float32 and against
        JAX's bfloat16 codec; under 2% of the y symbols differ from JAX's
        bfloat16 codec on each wire. (The rate is held by the eval
        forward's likelihoods: these streams are 70-80 bytes an image, of
        which the lanes' flushed states and lengths and the header are a
        fixed part, so a symbol or two moves their bytes by a few percent.)"""
        tm, x = twin["tm"], twin["x"]
        xs = torch.from_numpy(x)
        jm, variables = twin["jm"], {"params": twin["params"]}
        jnn.set_activation_dtype(jnp.bfloat16)  # before the JAX codecs trace
        # one JAX codec serves both wires, which share its compiled functions
        jdev = JaxDeviceWireCodec(jm, variables, lanes_per_image=LANES)
        jc = JaxHostWire(jdev)
        jenc = jc.compress(jnp.asarray(x), return_debug=True)
        jx_hat = jc.decompress(jenc["strings"], jenc["shape"])["x_hat"]
        jdenc = jdev.compress(jnp.asarray(x), return_debug=True)
        jnn.set_activation_dtype(None)
        tables = port_tables(jdev.tables)
        f32 = tmodels.CharmCodec(tm, tables=tables).compress(xs, return_debug=True)
        tnn.set_activation_dtype(BF16)
        host = tmodels.CharmCodec(tm, tables=tables)
        enc = host.compress(xs, return_debug=True)
        dec = host.decompress(enc["strings"], enc["shape"])
        assert enc["y_hat"].dtype == BF16
        assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
        wire = tmodels.DeviceWireCodec(tm, lanes_per_image=LANES, tables=tables)
        denc = wire.compress(xs, return_debug=True)
        ddec = wire.decompress(denc["strings"], denc["shape"])
        assert torch.equal(ddec["y_hat"], denc["y_hat"]) and torch.equal(ddec["x_hat"], denc["x_hat"])
        assert torch.equal(denc["y_hat"], enc["y_hat"])

        def n_bytes(e):
            return sum(len(s) for k in (0, 1) for s in e["strings"][k])

        for against, ref in (("f32", f32["x_hat"]), ("JAX bf16", jx_hat)):
            mean = float(np.abs(dec["x_hat"].float().numpy() - np.asarray(ref, np.float32)).mean())
            print(f"{self.name} codec bf16 against {against}: mean |x_hat difference| {mean:.2e}")
            assert mean < XHAT_MEAN_TOL, against
        print(f"{self.name} bytes: bf16 host {n_bytes(enc)}, device {n_bytes(denc)}; f32 host "
              f"{n_bytes(f32)}; JAX bf16 host {n_bytes(jenc)}, device {n_bytes(jdenc)}")
        for wire_name, port_y, jax_y in (("host", enc["y_hat"], jenc["y_hat"]),
                                         ("device", denc["y_hat"], jdenc["y_hat"])):
            share = float((np.abs(_nhwc(port_y) - np.asarray(jax_y, np.float32)) > 0.5).mean())
            print(f"{self.name} {wire_name} wire: y symbols that differ from JAX's bfloat16 "
                  f"codec: {share:.2e} (bar {SYMBOL_SHARE_TOL})")
            assert share <= SYMBOL_SHARE_TOL, wire_name


# --- the family's tests without a JAX twin ----------------------------------------------

def _refiner_case(scan_charm: bool):
    """A stf7like model at stochastic depth 0.5 in training mode (its mu
    refiner's two blocks at rates 0 and 0.5) and a mu refiner's input."""
    tm = _port_model("stf7like", drop_path_rate=0.5, scan_charm=scan_charm).train()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, tm.slice_ch, 4, 4)).astype(np.float32))
    return tm, x


def test_refiner_stochastic_depth_repeats_with_one_generator():
    tm, x = _refiner_case(True)
    with torch.no_grad():
        a = tm.refine("mu", 1, x, torch.Generator().manual_seed(3))
        b = tm.refine("mu", 1, x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_refiner_stochastic_depth_differs_between_generators():
    """Two generators drop other branches: at rate 0.5 over 4 samples, the
    outputs differ, and each differs from the deterministic refiner's."""
    tm, x = _refiner_case(True)
    with torch.no_grad():
        a = tm.refine("mu", 1, x, torch.Generator().manual_seed(3))
        b = tm.refine("mu", 1, x, torch.Generator().manual_seed(4))
        det = tm.refine("mu", 1, x)
    assert not torch.equal(a, b)
    assert not torch.equal(a, det) and not torch.equal(b, det)


def test_refiners_without_a_generator_are_deterministic():
    """No generator: the refiner and the whole ``scan_charm=True``
    forward are deterministic, in training mode too, and equal the
    unrolled forward."""
    tm, x = _refiner_case(True)
    unrolled = _port_model("stf7like", drop_path_rate=0.5).train()
    unrolled.load_state_dict(tm.state_dict())
    img = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(tm.refine("mu", 1, x), tm.refine("mu", 1, x))
        a, b, c = tm(img), tm(img), unrolled(img)
    assert torch.equal(a["x_hat"], b["x_hat"]) and torch.equal(a["x_hat"], c["x_hat"])
    assert torch.equal(a["likelihoods"]["y"], c["likelihoods"]["y"])


def test_unrolled_forward_runs_its_refiners_without_stochastic_depth():
    """JAX's unrolled forward calls its refiners deterministic: with a
    generator the port's unrolled slice context (its mu) equals the one
    without, and the ``scan_charm`` one does not."""
    img = torch.from_numpy(np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32))
    for scan_charm, same in ((False, True), (True, False)):
        tm, _ = _refiner_case(scan_charm)
        with torch.no_grad():
            y, z = tm.analyze(img.permute(0, 3, 1, 2))
            state = tm.ctx_prepare(torch.round(z))
            support = tm.latent_slices(y)[:1]
            with_gen = tm.forward_slice_context(1, state, support,
                                                torch.Generator().manual_seed(1))
            without = tm.forward_slice_context(1, state, support)
        assert torch.equal(with_gen[0], without[0]) == same


def test_from_jax_params_needs_the_model_for_a_zigzag_scan_tree():
    with pytest.raises(ValueError, match="model"):
        from_jax_params({"zigzag_scan": {}, "h_mean_s": {}})
