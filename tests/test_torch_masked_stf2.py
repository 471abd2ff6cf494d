"""The masked family's ``stf2`` (``ClipEncoder``, the token-autoregressive
attention codec): icm_tpu_torch against the JAX package.

Narrow twins at ``tests/test_masked_codec.py``'s ``TINY`` transforms
(embed 8, depths (1, 1): an 8 x 8 latent of 16 channels on a 32 x 32
image) with stf2's token geometry cut down as in
``tests/test_masked_czigzag.py`` (2 slices), two images, parameters drawn
with numpy at the shapes of the JAX twin's init
(``test_torch_masked.make_twin``). Each twin's tests run in a file of their
own (:class:`Stf2Twin`), so that the suite's workers run them side by side:

- ``test_torch_masked_stf2like.py``: mask window 2, 3 sliding tokens: 32
  tokens of D = 32, the history longer than its window from token 4 on;
- ``_stf2like_padded.py``: mask window 3, 4 sliding tokens: the latent
  padded from 8 to 9 (tokens built from the padded latent, y_hat cropped
  after the merge), 18 tokens of D = 72;
- each: the eval forward within 1e-4 of JAX's x_hat and likelihoods, the
  host and device wires (the token scan) round trip bit for bit, their
  y_hat and x_hat equal, 0 y symbols off JAX's ``Stf2Codec``'s, both
  streams byte for byte with it on both wires (the device wire's tier byte
  included) given JAX's tables, decoding across the two frameworks both
  ways, the device wire's programs run as graphs and launch by launch
  alike (on the CPU ``GraphCache`` runs both launch by launch: the card
  tests hold graphs against launches), and one float64 training step
  against each of JAX's two forwards (the unrolled loop and
  ``scan_tokens=True``) within 1e-6 of each gradient's max.

This file holds what the twins share and the tests without a twin: the
windowed zigzag tokens (``zigzag_split_tokens``), the hyper windows'
unfold scramble, one step's context against JAX's ``token_context``
(both concat orders) and LRP, the full-width model's eval forward on
64 x 64 and its parameter count, the registry and the codec's checks.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL
from test_torch_masked import (FORWARD_TOL, GRAD_TOL, TINY, _images, make_twin, nhwc,
                               stf2_noise)
from test_torch_stf import _params_from_numpy
from test_torch_stf_family import port_tables
from test_torch_stf_family_paths import _f64_port_params
from test_torch_train import _close, _replay

from icm_tpu.models import masked_ctx as jmc
from icm_tpu.models import models as jax_models
from icm_tpu.models.crc_codec import Stf2Codec as JaxStf2Codec
from icm_tpu.scan import zigzag_split_tokens as jax_zigzag_split_tokens
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models import masked_ctx as tmc
from icm_tpu_torch.models.masked_codec import Stf2Codec
from icm_tpu_torch.scan import zigzag_split_tokens

torch.set_num_threads(2)

# stf2's token geometry on TINY's transforms: 2 slices of 8 channels
STF2_TINY = {**TINY, "num_slices": 2}


def jax_stf2_step(name_config: dict, params, x64, noise, monkeypatch, scan: bool):
    """JAX's float64 RateDistortionLoss(0.01) + aux step of the stf2 twin
    -> (metrics, gradients, the noise replay)."""
    jcls, jkw = jax_models["stf2"]
    jm = jcls(**{**jkw, **name_config}, scan_tokens=scan)
    tr, jr = _replay(monkeypatch, noise[0])
    tr.noise = noise[1]
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(x64), training=True,
                       rngs={"noise": key, "dropout": key})
        rd = JaxRD(0.01)(out, jnp.asarray(x64))
        aux = jm.apply({"params": p}, method=jm.aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    with jax.enable_x64(True):
        # the port's state dict holds the float32 rounding of the numpy draws
        p64 = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32).astype(np.float64), params)
        (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
        ref_m, ref_g = jax.device_get((ref_m, ref_g))
    assert jr.i == len(noise[0])
    return ref_m, ref_g, tr


class Stf2Twin:
    """The tests of one narrow stf2 twin; a file per twin subclasses it as
    ``Test<Twin>`` with ``config`` (over ``STF2_TINY``) set."""

    config: dict = {}

    @pytest.fixture(scope="class")
    def twin(self):
        config = {**STF2_TINY, **self.config}
        jm, variables, tm, x = make_twin("stf2", config)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, xj)
        jc = {w: JaxStf2Codec(jm, variables, wire=w) for w in ("host", "device")}
        port = {w: Stf2Codec(tm, tables=port_tables(jc[w].tables), wire=w)
                for w in ("host", "device")}
        return dict(jm=jm, variables=variables, tm=tm, x=x, ref=ref, config=config, jc=jc,
                    port=port, jenc={w: c.compress(xj, return_debug=True) for w, c in jc.items()},
                    enc={w: c.compress(xt, return_debug=True) for w, c in port.items()})

    def test_state_dict_covers_every_jax_parameter(self, twin):
        assert (len(jax.tree_util.tree_leaves(twin["variables"]["params"]))
                == len(twin["tm"].state_dict()))

    def test_eval_forward_matches_jax(self, twin):
        """x_hat and both likelihoods within 1e-4 (y's: each token's block
        concatenated along the channels, token by token)."""
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]))
        ref = twin["ref"]
        pairs = [(out["x_hat"], ref["x_hat"], "x_hat")] + [
            (out["likelihoods"][k], ref["likelihoods"][k], k) for k in "yz"]
        print("stf2: largest |port - JAX|:",
              {n: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, n in pairs})
        for a, b, n in pairs:
            assert a.shape == b.shape, n
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=n)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_roundtrip_bitexact(self, twin, wire):
        enc = twin["enc"][wire]
        codec = twin["port"][wire]
        dec = codec.decompress(enc["strings"], *(enc[k] for k in codec.DECOMPRESS_KEYS))
        assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape
        assert dec["y_hat"].shape[2:] == enc["out_hw"]

    def test_device_wire_floats_are_the_host_wire_floats(self, twin):
        host, dev = twin["enc"]["host"], twin["enc"]["device"]
        assert torch.equal(dev["y_hat"], host["y_hat"]) and torch.equal(dev["x_hat"], host["x_hat"])

    def test_graphed_and_launched_device_wire_agree(self, twin):
        """The device wire with ``cuda_graphs=False``: the same blobs and the
        same y_hat / x_hat bits (on the CPU both run launch by launch)."""
        codec = Stf2Codec(twin["tm"], tables=twin["port"]["device"].tables, wire="device",
                          cuda_graphs=False)
        enc = codec.compress(torch.from_numpy(twin["x"]), return_debug=True)
        graphed = twin["enc"]["device"]
        assert enc["strings"] == graphed["strings"]
        dec = codec.decompress(enc["strings"], *(enc[k] for k in codec.DECOMPRESS_KEYS))
        for k in ("y_hat", "x_hat"):
            assert torch.equal(enc[k], graphed[k]) and torch.equal(dec[k], graphed[k]), k

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_symbols_match_jax(self, twin, wire):
        """0 of the y symbols differ from the JAX codec's, some of them are
        nonzero, the decoder's x_hat is JAX's within the forward's bar, and
        the geometry compress hands the decoder is JAX's."""
        enc, jenc = twin["enc"][wire], twin["jenc"][wire]
        port_y, jax_y = nhwc(enc["y_hat"]), np.asarray(jenc["y_hat"])
        flipped = np.abs(port_y - jax_y) > 0.5
        sym = twin["port"][wire].symbols(torch.from_numpy(twin["x"]))
        share = float((sym != 0).float().mean())
        print(f"stf2 {wire}: symbols off JAX's {flipped.sum()} of {flipped.size}; "
              f"nonzero {share:.1%}")
        assert flipped.sum() == 0 and share > 0
        np.testing.assert_allclose(port_y, jax_y, rtol=0, atol=CROSS_TOL)
        np.testing.assert_allclose(enc["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)
        for k in Stf2Codec.DECOMPRESS_KEYS:
            assert tuple(enc[k]) == tuple(jenc[k]), k

    @pytest.mark.parametrize("wire", ["host", "device"])
    @pytest.mark.parametrize("stream", ["y", "z"])
    def test_streams_match_jax_byte_for_byte(self, twin, wire, stream):
        k = "yz".index(stream)
        got, want = twin["enc"][wire]["strings"][k], twin["jenc"][wire]["strings"][k]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"{stream} stream of image {b}: {len(g)} vs {len(w)} bytes"
        if wire == "device" and stream == "y":  # JAX's scan-wire framing and tier byte
            assert all(g[3] == WIRE_SCAN and g[4] in (0, 1, 2) for g in got)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_port_decodes_the_jax_streams(self, twin, wire):
        jenc = twin["jenc"][wire]
        codec = twin["port"][wire]
        dec = codec.decompress(jenc["strings"], *(jenc[k] for k in codec.DECOMPRESS_KEYS))
        np.testing.assert_allclose(nhwc(dec["y_hat"]), np.asarray(jenc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(dec["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_jax_decodes_the_port_streams(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["jc"][wire].decompress(enc["strings"], enc["shape"], enc["out_hw"],
                                          enc["lattice"])
        np.testing.assert_allclose(np.asarray(dec["y_hat"]), nhwc(enc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(), rtol=0,
                                   atol=FORWARD_TOL)

    @pytest.mark.parametrize("forward", ["unrolled", "scan_tokens"])
    def test_train_step_matches_jax(self, twin, forward, monkeypatch):
        """One training step of the port's one forward against each of
        JAX's (the unrolled loop, and ``scan_tokens=True``: one
        ``lax.scan``, the same parameter tree), in float64 on both sides,
        weights rounded through float32 on both, stochastic depth 0, the
        same noise: RateDistortionLoss and the aux loss within 1e-6, every
        gradient within 1e-6 of its max."""
        config = twin["config"]
        x64 = twin["x"].astype(np.float64)
        tm = tmodels.create_model("stf2", device="cpu", **config)
        tm.load_state_dict(twin["tm"].state_dict())
        tm = tm.double().train()
        noise = stf2_noise(tm, *x64.shape[:2], scan=forward == "scan_tokens")
        ref_m, ref_g, tr = jax_stf2_step(config, jax.device_get(twin["variables"]["params"]),
                                         x64, noise, monkeypatch, forward == "scan_tokens")
        out = tm(torch.from_numpy(x64), generator=torch.Generator())
        assert out["x_hat"].dtype == torch.float64
        rd = ttrain.RateDistortionLoss(0.01)(out, torch.from_numpy(x64))
        aux = tm.aux_loss()
        (rd["loss"] + aux).backward()
        assert tr.i == len(noise[1])
        for k, v in {**rd, "aux_loss": aux}.items():
            _close(v.item(), ref_m[k], GRAD_TOL, k)
        ref_grads = _f64_port_params(ref_g, tm)
        assert set(ref_grads) == {n for n, _ in tm.named_parameters()}
        assert all(p.grad is not None for p in tm.parameters())
        worst = {n: _close(p.grad.numpy(), ref_grads[n], GRAD_TOL, n)
                 for n, p in tm.named_parameters()}
        print(f"stf2 {forward}: largest gradient error relative to its max:",
              max(worst.items(), key=lambda kv: kv[1]))


# --- the modules against their JAX counterparts -----------------------------------------


@pytest.mark.parametrize("shape,slices,ws", [((2, 16, 8, 8), 2, 2), ((1, 12, 9, 7), 4, 3),
                                             ((2, 8, 8, 8), 2, 8)])
def test_zigzag_split_tokens_match_jax(shape, slices, ws):
    """The port's channel-major tokens are JAX's (h, w, c) tokens with
    each block transposed, the padding and the lattice alike."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, jh, jw = jax_zigzag_split_tokens(jnp.asarray(x.transpose(0, 2, 3, 1)), slices, ws)
    got, nH, nW = zigzag_split_tokens(torch.from_numpy(x), slices, ws)
    B, N, D = got.shape
    assert (nH, nW) == (jh, jw) and tuple(want.shape) == (B, N, D)
    blocks = np.asarray(want).reshape(B, N, ws, ws, D // ws ** 2).transpose(0, 1, 4, 2, 3)
    np.testing.assert_array_equal(got.numpy(), blocks.reshape(B, N, D))


@pytest.mark.parametrize("window", [3, 6])
def test_unfold_scramble_matches_jax(window):
    """stf2's hyper windows: JAX's scramble of its front-padded causal
    windows (current token included), bit for bit."""
    t = np.random.default_rng(2).standard_normal((2, 9, 12)).astype(np.float32)
    want = jmc._unfold_scramble(jmc._causal_windows(jnp.asarray(t), window, True))
    got = tmc._unfold_scramble(torch.from_numpy(t), window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def step_twin():
    config = {**STF2_TINY, "mask_win_size": 2, "num_sliding": 3}
    jm, variables, tm, _ = make_twin("stf2", config, seed=3)
    rng = np.random.default_rng(6)
    D = tm.token_dim
    arrays = [rng.standard_normal((2, 3, D)).astype(np.float32) for _ in range(3)]
    return jm, variables, tm, arrays


@pytest.mark.parametrize("first", [True, False])
def test_token_context_matches_jax(step_twin, first):
    """One step: mu, scale (NCHW blocks against JAX's NHWC ones) and mu's
    context image (channel k C' + c) from hyper windows and a history, in
    the first step's order and the later steps'; then the LRP on it."""
    jm, variables, tm, (m_i, s_i, prev) = step_twin
    want = jm.apply(variables, *map(jnp.asarray, (m_i, s_i, prev)), first,
                    method=jm.token_context)
    y_hat = np.random.default_rng(7).standard_normal(np.asarray(want[0]).shape).astype(np.float32)
    want_lrp = jm.apply(variables, want[2], jnp.asarray(y_hat), method=jm.token_lrp)
    with torch.no_grad():
        got = tm.token_context(*map(torch.from_numpy, (m_i, s_i, prev)), first)
        got_lrp = tm.token_lrp(got[2], torch.from_numpy(y_hat.transpose(0, 3, 1, 2).copy()))
    for g, w in zip(got + (got_lrp,), want + (want_lrp,)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-5)


def test_both_concat_orders_are_used(step_twin):
    """The first step's order differs from the later steps': the same inputs
    give another mu."""
    _, _, tm, arrays = step_twin
    with torch.no_grad():
        a, b = (tm.token_context(*map(torch.from_numpy, arrays), first)[0]
                for first in (True, False))
    assert not torch.equal(a, b)


# --- the full-width model, the registry, the codec's checks -------------------------------

# the JAX registry model's parameter count (jax.eval_shape of its init)
STF2_PARAMS = 337_126_167


def test_full_width_eval_forward_matches_jax():
    """The registry's full-width stf2 (embed 48, depths 2/2/6/2, M = 384, 4
    slices of 96, windows of 8: tokens of D = 6144, 6 sliding) against its
    JAX twin on one 64 x 64 image (a 4 x 4 latent padded to one 8 x 8
    window: 4 tokens), parameters drawn at ``jax.eval_shape``'s shapes, at
    the narrow twins' bar; the port's parameter count is the JAX model's."""
    x = _images(1, 64, seed=3)
    jcls, jkw = jax_models["stf2"]
    jm = jcls(**jkw)
    variables = _params_from_numpy(jm, x, seed=4)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(variables["params"]))
    ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, jnp.asarray(x))
    # 1.35 GB a copy of the weights: one copy at a time beside the state dict
    state = from_jax_params(variables["params"])
    del variables
    gc.collect()
    with torch.device("meta"):
        tm = tmodels.models["stf2"][0]()
    tm = tm.to_empty(device="cpu").eval()
    tm.load_state_dict(state, strict=True)
    del state
    assert sum(p.numel() for p in tm.parameters()) == n_jax == STF2_PARAMS
    assert (tm.token_dim, tm.slice_ch, tm.num_slices, tm.mask_win_size, tm.num_sliding) == (
        6144, 96, 4, 8, 6)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    for a, b in [(out["x_hat"], ref["x_hat"])] + [(out["likelihoods"][k], ref["likelihoods"][k])
                                                  for k in "yz"]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL, atol=FORWARD_TOL)


def test_registry_holds_the_jax_defaults():
    """The port's registry builds JAX's class at its defaults, on the card
    unless the CPU is asked for; its dense layers at flax's fan-in scale."""
    cls, kwargs = tmodels.models["stf2"]
    jcls, jkwargs = jax_models["stf2"]
    assert cls.__name__ == jcls.__name__ == "ClipEncoder" and kwargs == jkwargs == {}
    with torch.device("meta"):
        m = cls()
    assert (m.num_slices, m.mask_win_size, m.num_sliding, m.latent_dim) == (4, 8, 6, 384)
    assert sum(p.numel() for p in m.parameters()) == STF2_PARAMS
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodels.create_model("stf2", **STF2_TINY)
    small = tmodels.create_model("stf2", device="cpu", seed=0, **STF2_TINY)
    qkv = small.muContextModel.qkv.weight
    assert abs(float(qkv.detach().std()) * np.sqrt(qkv.shape[1]) - 1.0) < 0.15


def test_codec_checks_its_arguments():
    model = tmodels.create_model("stf2", device="cpu", **STF2_TINY)
    with pytest.raises(ValueError, match="wire"):
        Stf2Codec(model, wire="scan")
    with pytest.raises(ValueError, match="num_stride_sliding"):
        tmodels.create_model("stf2", device="cpu", num_stride_sliding=2, **STF2_TINY)
    codec = Stf2Codec(model, wire="device")
    x = torch.from_numpy(_images(2, 32))
    enc = codec.compress(x)
    with pytest.raises(ValueError, match="wires"):
        codec.decompress([enc["strings"][0][:1], enc["strings"][1]], enc["shape"],
                         enc["out_hw"], enc["lattice"])
