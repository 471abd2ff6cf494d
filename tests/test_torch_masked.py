"""The masked-transformer codecs ``stf3`` and ``stf4``: icm_tpu_torch against
the JAX package.

Narrow twins at ``tests/test_masked_codec.py``'s ``TINY`` (embed 8,
depths (1, 1), 4 slices, mask window 2: tokens of D = 16, 64 of them on a
32 x 32 image) on two images. The JAX twin's parameters are drawn with
numpy at the shapes of its init (``jax.eval_shape``; kernels, dense ones
too, fan-in scaled, LayerNorm near one, small biases) and carried over
with ``from_jax_params``. Each twin's tests run in a file of their own
(:class:`MaskedTwin`), so that the suite's workers run them side by side:

- ``test_torch_masked_stf3like.py``: stf3 with the reference's -1000 block
  mask (its default), ``_stf3like_causal.py``: stf3 with ``causal=True``,
  ``_stf4like.py``: stf4 with ``causal=True`` (its codec needs it) and a
  sliding window of 8, its training forward the reference mask's;
- each: the eval forward within 1e-4 of JAX's x_hat and likelihoods, the
  coder's context pass within 1e-5 of JAX's, the host and device wires'
  round trips bit for bit, the two wires' y_hat and x_hat equal, 0 y
  symbols off JAX's ``Stf3Codec``'s, both streams byte for byte with it
  on both wires (the device wire's tier byte included) given JAX's tables
  (``tables=``), decoding across the two frameworks both ways, the
  row-independence invariant of the context pass on the CPU, and one
  float64 training step (stochastic depth 0, the same noise replayed into
  both) within 1e-6 of each gradient's max.

The bfloat16 policy's twins (:class:`MaskedBf16Twin`, stf3 and stf4's
:class:`OneShotBf16Twin`) run in ``test_torch_masked_bf16_stf{2,3,4}.py``,
against JAX's models under its policy at ``tests/test_bf16.py``'s bars.

This file holds what the twins share and the tests without a twin: each
module against its flax counterpart (``PlainAttention`` under both mask
kinds, ``MaskedContextModel``, ``_causal_windows``, stf4's fused heads with
the reference's scramble), the full-width models' eval forward on 64 x 64,
the registry and the codec's refusal of a non-causal stf4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import BF16, BPP_RTOL, SYMBOL_SHARE_TOL, XHAT_MEAN_TOL, _assert_bf16_close
from test_torch_cnn_codec import CROSS_TOL
from test_torch_stf import _params_from_numpy
from test_torch_stf_family import on_wires, port_tables
from test_torch_stf_family_paths import _f64_port_params
from test_torch_train import _close, _replay

from icm_tpu import nn as jnn
from icm_tpu.models import masked_ctx as jmc
from icm_tpu.models import models as jax_models
from icm_tpu.models.crc_codec import Stf2Codec as JaxStf2Codec
from icm_tpu.models.masked_codec import Stf3Codec as JaxStf3Codec
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models import masked_ctx as tmc
from icm_tpu_torch.models.masked_codec import Stf2Codec, Stf3Codec, Stf4Codec

torch.set_num_threads(2)

# tests/test_masked_codec.py's TINY, without its causal flag (each twin sets it)
TINY = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window_size=4, patch_size=2,
            drop_path_rate=0.0, num_slices=4, mask_win_size=2,
            hyper_enc_widths=(16, 14, 12, 10, 8), hyper_dec_widths=(10, 12, 14, 16, 16))
# the eval forward of the two frameworks: f32 sums in another order
FORWARD_TOL = 1e-4
# one float64 training step: the same function in another order of sums
GRAD_TOL = 1e-6


def _images(n: int = 2, size: int = 32, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


def make_twin(name: str, config: dict, seed: int = 1):
    """-> (JAX model, its variables, the port's model with them, images)."""
    x = _images()
    jcls, jkw = jax_models[name]
    jm = jcls(**{**jkw, **config})
    variables = _params_from_numpy(jm, x, seed)
    tm = tmodels.create_model(name, device="cpu", **config)
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return jm, variables, tm.eval(), x


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def stf2_noise(tm, B: int, size: int, scan: bool, seed: int = 5) -> tuple:
    """-> (JAX's noise arrays, the port's) of one stf2 training forward, in
    the order both draw them: z (the bottleneck's (C, 1, n)), then each
    token's y block (NHWC (B, ws, ws, C')). JAX's ``scan_tokens=True``
    forward draws token 0's outside its scan and traces the scan's step
    twice (once to build it), so one array stands for every later token
    there, and the port is handed that array for each."""
    rng = np.random.default_rng(seed)
    h = size // tm.latent_stride
    N = tm.num_slices * (-(-h // tm.mask_win_size)) ** 2
    z = rng.uniform(-0.5, 0.5, (tm.entropy_bottleneck.channels, 1, B * (-(-h // 4)) ** 2))
    ws, Cp = tm.mask_win_size, tm.slice_ch
    ys = [rng.uniform(-0.5, 0.5, (B, ws, ws, Cp)) for _ in range(N)]
    if scan:
        return [z, ys[0], ys[1], ys[1]], [z, ys[0]] + [ys[1]] * (N - 1)
    return [z] + ys, [z] + ys


def _noise(config: dict, B: int = 2, size: int = 32, seed: int = 5) -> list:
    """A training forward's noise in the order both frameworks draw it: z
    (the bottleneck's (C, 1, n) layout), then y (NHWC)."""
    rng = np.random.default_rng(seed)
    M = config["embed_dim"] * 2 ** (len(config["depths"]) - 1)
    h = size // 2 ** len(config["depths"])  # the latent's side (patch 2, then merges); z's a quarter
    return [rng.uniform(-0.5, 0.5, (config["hyper_enc_widths"][-1], 1, B * (h // 4) ** 2)),
            rng.uniform(-0.5, 0.5, (B, h, h, M))]


class MaskedTwin:
    """The tests of one narrow twin; a file per twin subclasses it as
    ``Test<Twin>`` with ``name``, ``config`` (over ``TINY``) and
    ``train_config`` (the training forward's, stf4's reference mask) set."""

    name = ""
    config: dict = {}
    train_config: dict = {}

    @pytest.fixture(scope="class")
    def twin(self):
        config = {**TINY, **self.config}
        jm, variables, tm, x = make_twin(self.name, config)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, xj)
        jc = on_wires(JaxStf3Codec(jm, variables, wire="device"))
        port = {w: Stf3Codec(tm, tables=port_tables(jc[w].tables), wire=w)
                for w in ("host", "device")}
        return dict(jm=jm, variables=variables, tm=tm, x=x, ref=ref, config=config, jc=jc,
                    port=port, jenc={w: c.compress(xj, return_debug=True) for w, c in jc.items()},
                    enc={w: c.compress(xt, return_debug=True) for w, c in port.items()})

    def test_state_dict_covers_every_jax_parameter(self, twin):
        assert (len(jax.tree_util.tree_leaves(twin["variables"]["params"]))
                == len(twin["tm"].state_dict()))

    def test_eval_forward_matches_jax(self, twin):
        """x_hat and both likelihoods within 1e-4."""
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]))
        ref = twin["ref"]
        pairs = [(out["x_hat"], ref["x_hat"], "x_hat")] + [
            (out["likelihoods"][k], ref["likelihoods"][k], k) for k in "yz"]
        print(f"{self.name}: largest |port - JAX|:",
              {n: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, n in pairs})
        for a, b, n in pairs:
            assert a.shape == b.shape, n
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=n)

    def _tokens(self, twin):
        """The encoder's tokens in both frameworks: (JAX's, the port's)."""
        jm, v, tm = twin["jm"], twin["variables"], twin["tm"]
        y, z = jm.apply(v, jnp.asarray(twin["x"]), method=jm.analyze)
        med = jm.apply(v, method=jm.eb_medians)
        j = jm.apply(v, y, jnp.round(z - med) + med, method=jm.coder_tokens)
        port = tuple(torch.from_numpy(np.array(a)) for a in j[:3])
        return j, port

    def test_context_pass_matches_jax(self, twin):
        """``causal_mu_scale`` on JAX's tokens: mu and scale within 1e-5."""
        jm, v, tm = twin["jm"], twin["variables"], twin["tm"]
        j, (y_tok, m_tok, s_tok) = self._tokens(twin)
        want = jm.apply(v, j[1], j[2], j[0], method=jm.causal_mu_scale)
        with torch.no_grad():
            got = tm.causal_mu_scale(m_tok, s_tok, y_tok)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("i", [0, 1, 17, 63])
    def test_context_rows_ignore_the_rows_after_them(self, twin, i):
        """The decoder's invariant: the pass's rows <= i are bit-identical
        after the buffer's rows >= i change (to zeros, as the decoder's
        buffer holds, and to other integers)."""
        tm = twin["tm"]
        _, (y_tok, m_tok, s_tok) = self._tokens(twin)
        g = torch.Generator().manual_seed(i)
        with torch.no_grad():
            base = tm.causal_mu_scale(m_tok, s_tok, y_tok)
            for fill in (torch.zeros_like(y_tok), torch.randint(-4, 5, y_tok.shape, generator=g)):
                buf = y_tok.clone()
                buf[:, i:] = fill[:, i:].to(buf.dtype)
                got = tm.causal_mu_scale(m_tok, s_tok, buf)
                for a, b in zip(got, base):
                    assert torch.equal(a[:, :i + 1], b[:, :i + 1])
                if i + 1 < y_tok.shape[1]:  # and the later rows do read it
                    assert not all(torch.equal(a[:, i + 1:], b[:, i + 1:])
                                   for a, b in zip(got, base))

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_roundtrip_bitexact(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["port"][wire].decompress(enc["strings"], enc["shape"])
        assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape

    def test_device_wire_floats_are_the_host_wire_floats(self, twin):
        host, dev = twin["enc"]["host"], twin["enc"]["device"]
        assert torch.equal(dev["y_hat"], host["y_hat"]) and torch.equal(dev["x_hat"], host["x_hat"])

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_symbols_match_jax(self, twin, wire):
        """0 of the y symbols differ from the JAX codec's, some of them are
        nonzero, and the decoder's x_hat is JAX's within the forward's
        bar."""
        enc, jenc = twin["enc"][wire], twin["jenc"][wire]
        port_y, jax_y = nhwc(enc["y_hat"]), np.asarray(jenc["y_hat"])
        flipped = np.abs(port_y - jax_y) > 0.5
        sym = twin["port"][wire].symbols(torch.from_numpy(twin["x"]))
        share = float((sym != 0).float().mean())
        print(f"{self.name} {wire}: symbols off JAX's {flipped.sum()} of {flipped.size}; "
              f"nonzero {share:.1%}")
        assert flipped.sum() == 0 and share > 0
        np.testing.assert_allclose(port_y, jax_y, rtol=0, atol=CROSS_TOL)
        np.testing.assert_allclose(enc["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)
        assert enc["shape"] == tuple(jenc["shape"])

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
        dec = twin["port"][wire].decompress(jenc["strings"], jenc["shape"])
        np.testing.assert_allclose(nhwc(dec["y_hat"]), np.asarray(jenc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(dec["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)

    @pytest.mark.parametrize("wire", ["host", "device"])
    def test_jax_decodes_the_port_streams(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["jc"][wire].decompress(enc["strings"], enc["shape"])
        np.testing.assert_allclose(np.asarray(dec["y_hat"]), nhwc(enc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(), rtol=0,
                                   atol=FORWARD_TOL)

    def test_train_step_matches_jax(self, twin, monkeypatch):
        """One training step of the training forward's model (stf4: the
        reference mask, as JAX trains it) in float64 on both sides, weights
        rounded through float32 on both, stochastic depth 0, the same noise:
        RateDistortionLoss and the aux loss within 1e-6, every gradient
        within 1e-6 of its max. stf4's scale head, which no forward applies,
        gets no gradient in the port and a zero one in JAX."""
        config = {**twin["config"], **self.train_config}
        jcls, jkw = jax_models[self.name]
        jm = jcls(**{**jkw, **config})
        params = jax.device_get(twin["variables"]["params"])
        tm = tmodels.create_model(self.name, device="cpu", **config)
        tm.load_state_dict(twin["tm"].state_dict())
        tm = tm.double().train()
        x64 = twin["x"].astype(np.float64)
        noise = _noise(config)
        tr, jr = _replay(monkeypatch, noise)
        key = jax.random.PRNGKey(0)

        def loss_fn(p):
            out = jm.apply({"params": p}, jnp.asarray(x64), training=True,
                           rngs={"noise": key, "dropout": key})
            rd = JaxRD(0.01)(out, jnp.asarray(x64))
            aux = jm.apply({"params": p}, method=jm.aux_loss)
            return rd["loss"] + aux, {**rd, "aux_loss": aux}

        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
            (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
            ref_m, ref_g = jax.device_get((ref_m, ref_g))
        assert jr.i == len(noise)
        out = tm(torch.from_numpy(x64), generator=torch.Generator())
        assert out["x_hat"].dtype == torch.float64
        rd = ttrain.RateDistortionLoss(0.01)(out, torch.from_numpy(x64))
        aux = tm.aux_loss()
        (rd["loss"] + aux).backward()
        assert tr.i == len(noise)
        for k, v in {**rd, "aux_loss": aux}.items():
            _close(v.item(), ref_m[k], GRAD_TOL, k)
        ref_grads = _f64_port_params(ref_g, tm)
        assert set(ref_grads) == {n for n, _ in tm.named_parameters()}
        idle = {n for n, p in tm.named_parameters() if p.grad is None}
        assert idle == {n for n in ref_grads if n.startswith("cc_scale_head.")}
        assert not any(np.any(ref_grads[n]) for n in idle)
        worst = {n: _close(p.grad.numpy(), ref_grads[n], GRAD_TOL, n)
                 for n, p in tm.named_parameters() if n not in idle}
        print(f"{self.name}: largest gradient error relative to its max:",
              max(worst.items(), key=lambda kv: kv[1]))


# tests/test_masked_czigzag.py's narrow transforms (embed 8, depths 1/1/1/1:
# a 4 x 4 latent of 64 channels on 64 x 64 images), on which JAX's own
# bfloat16 forward stays within tests/test_bf16.py's bars of its float32 one
# at the JAX model's init
TINY_SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
                 patch_size=2, drop_path_rate=0.0, hyper_enc_widths=(64, 56, 48, 40, 32),
                 hyper_dec_widths=(40, 48, 56, 64, 64))


class MaskedBf16Twin:
    """The bfloat16 policy's tests of one masked-family twin against JAX's
    model and codec under ``set_activation_dtype(jnp.bfloat16)``, at
    ``tests/test_bf16.py``'s bars (``test_torch_bf16.py``); a file per
    twin subclasses it as ``Test<Name>Bf16`` with ``name``, ``config``
    (over ``TINY_SWIN``) and ``train_config`` set.

    The twins take the JAX model's own init, on 2 x 64 x 64 images: with
    the float32 twins' numpy draws every model's y runs to thousands of
    bits a pixel and JAX's own bfloat16 x_hat strays 0.03-0.10 (mean) from
    its float32 one. At the init both packages' bfloat16 forwards stay
    about 0.004 from their float32 ones, and 0.0004 from each other (on
    the CPU). The policy: the transforms, hyper-codec and conv heads
    (stf2's three, stf3's LRP stack, stf4's fused heads and LRP) in
    bfloat16, the attention and MLP dense layers in float32 (a bfloat16
    input promoted, as flax's ``nn.Dense`` without a dtype does), the
    likelihoods float32."""

    name = ""
    config: dict = {}
    train_config: dict = {}

    @pytest.fixture(autouse=True)
    def _reset_policies(self):
        yield
        jnn.set_activation_dtype(None)
        tnn.set_activation_dtype(None)

    @pytest.fixture(scope="class")
    def twin(self):
        config = {**TINY_SWIN, **self.config}
        x = _images(2, 64)
        jcls, jkw = jax_models[self.name]
        jm = jcls(**{**jkw, **config})
        # JAX's init without its forward's compute (the same values as init)
        params = jax.device_get(jm.lazy_init(
            {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2),
             "dropout": jax.random.PRNGKey(3)}, jax.ShapeDtypeStruct(x.shape, jnp.float32),
            training=False)["params"])
        tm = tmodels.create_model(self.name, device="cpu", **config)
        tm.load_state_dict(from_jax_params(params), strict=True)
        return dict(jm=jm, params=params, tm=tm.eval(), x=x, config=config)

    def _codecs(self):
        if self.name == "stf2":
            return JaxStf2Codec, Stf2Codec
        return JaxStf3Codec, Stf3Codec

    def test_eval_forward_bf16_matches_jax_bf16(self, twin):
        """x_hat and every likelihood in JAX's dtypes; x_hat and bpp against
        JAX's bfloat16 forward and the port's float32 one."""
        jm, params, tm, x = twin["jm"], twin["params"], twin["tm"], twin["x"]
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
        for k in "yz":
            got = str(out["likelihoods"][k].dtype).split(".")[-1]
            assert got == np.asarray(ref["likelihoods"][k]).dtype.name == "float32", k

        def bpp(o):
            return sum(float(-np.log2(np.asarray(o["likelihoods"][k], np.float64)).sum())
                       for k in "yz") / n_px

        got_bpp = bpp({"likelihoods": {k: v.numpy() for k, v in out["likelihoods"].items()}})
        _assert_bf16_close(f"{self.name}: port bf16 against JAX bf16", out["x_hat"].float(),
                           got_bpp, ref["x_hat"], bpp(ref))
        _assert_bf16_close(f"{self.name}: port bf16 against port f32", out["x_hat"].float(),
                           got_bpp, f32["x_hat"],
                           bpp({"likelihoods": {k: v.numpy()
                                                for k, v in f32["likelihoods"].items()}}))

    def test_train_step_bf16_matches_jax_bf16(self, twin, monkeypatch):
        """One training step under the policy of the training forward's model
        (stf4: the reference mask), the same noise in both: float32
        gradients on float32 masters, all finite, every parameter's but
        stf4's scale head, which no forward applies; loss, bpp and MSE within
        5% of JAX's bfloat16 training forward (stf2's unrolled one), mean
        |x_hat difference| under 0.01, the aux loss within 1e-5."""
        self._train_step(twin, "unrolled", monkeypatch)

    def _train_step(self, twin, forward: str, monkeypatch):
        """:meth:`test_train_step_bf16_matches_jax_bf16` against JAX's
        ``forward`` ("unrolled", or stf2's "scan_tokens")."""
        config = {**twin["config"], **self.train_config}
        jcls, jkw = jax_models[self.name]
        jm = jcls(**{**jkw, **config}, **({"scan_tokens": True} if forward == "scan_tokens"
                                            else {}))
        tm = tmodels.create_model(self.name, device="cpu", **config)
        tm.load_state_dict(twin["tm"].state_dict())
        x = twin["x"]
        if self.name == "stf2":
            jax_noise, port_noise = stf2_noise(tm, x.shape[0], x.shape[1],
                                               forward == "scan_tokens")
        else:
            jax_noise = port_noise = _noise(config, x.shape[0], x.shape[1])
        tr, jr = _replay(monkeypatch, [a.astype(np.float32) for a in jax_noise])
        tr.noise = [a.astype(np.float32) for a in port_noise]
        key = jax.random.PRNGKey(0)
        jnn.set_activation_dtype(jnp.bfloat16)

        def terms(p):
            out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                           rngs={"noise": key, "dropout": key})
            rd = JaxRD(0.01)(out, jnp.asarray(x))
            return {**rd, "aux_loss": jm.apply({"params": p}, method=jm.aux_loss)}, out["x_hat"]

        ref_m, ref_x_hat = jax.jit(terms)(twin["params"])
        assert jr.i == len(jax_noise)
        tm.train()
        tnn.set_activation_dtype(BF16)
        state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 1.0))
        seen = {}
        handle = tm.register_forward_hook(
            lambda m, a, out: seen.update(x_hat=out["x_hat"].detach()))
        metrics = ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))(
            state, torch.from_numpy(x), torch.Generator())
        handle.remove()
        assert tr.i == len(port_noise)
        fixed = ("cc_scale_head.",) if self.name == "stf4" else ()
        grads = {n: p.grad for n, p in tm.named_parameters() if p.grad is not None}
        assert set(grads) == {n for n, _ in tm.named_parameters() if not n.startswith(fixed)}
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
        device wire (stf2's also launch by launch): bit-exact, the device
        wire's y_hat and x_hat the host wire's; the encoder's y_hat in the
        JAX codec's dtype (bfloat16); mean |x_hat difference| under 0.01
        against float32 and against JAX's bfloat16 codec; under 2% of the
        y symbols off JAX's bfloat16 codec on each wire, some nonzero."""
        jm, tm, x = twin["jm"], twin["tm"], twin["x"]
        xs = torch.from_numpy(x)
        jcls, tcls = self._codecs()
        jnn.set_activation_dtype(jnp.bfloat16)  # before the JAX codecs trace
        jc = on_wires(jcls(jm, {"params": twin["params"]}, wire="device"))
        jenc = {w: c.compress(jnp.asarray(x), return_debug=True) for w, c in jc.items()}
        jnn.set_activation_dtype(None)
        tables = port_tables(jc["device"].tables)
        f32 = tcls(tm, tables=tables).compress(xs, return_debug=True)
        tnn.set_activation_dtype(BF16)
        enc = {}
        runs = [("host", {}), ("device", {})]
        if self.name == "stf2":
            runs.append(("device", {"cuda_graphs": False}))
        for w, kw in runs:
            codec = tcls(tm, tables=tables, wire=w, **kw)
            e = codec.compress(xs, return_debug=True)
            d = codec.decompress(e["strings"], *(e[k] for k in codec.DECOMPRESS_KEYS))
            assert e["y_hat"].dtype == BF16
            assert str(e["y_hat"].dtype).split(".")[-1] == np.asarray(jenc[w]["y_hat"]).dtype.name
            assert torch.equal(d["y_hat"], e["y_hat"]) and torch.equal(d["x_hat"], e["x_hat"])
            if w in enc:  # launch by launch: the graphed device wire's blobs and bits
                assert e["strings"] == enc[w]["strings"]
                assert all(torch.equal(e[k], enc[w][k]) for k in ("y_hat", "x_hat"))
            enc[w] = e
            assert int(codec.symbols(xs).count_nonzero()) > 0
        for k in ("y_hat", "x_hat"):
            assert torch.equal(enc["device"][k], enc["host"][k]), k
        for against, ref in (("f32", f32["x_hat"]), ("JAX bf16", jenc["host"]["x_hat"])):
            mean = float(np.abs(enc["host"]["x_hat"].float().numpy()
                                - np.asarray(ref, np.float32)).mean())
            print(f"{self.name} codec bf16 against {against}: mean |x_hat difference| {mean:.2e}")
            assert mean < XHAT_MEAN_TOL, against
        for w in ("host", "device"):
            share = float((np.abs(nhwc(enc[w]["y_hat"].float())
                                  - np.asarray(jenc[w]["y_hat"], np.float32)) > 0.5).mean())
            print(f"{self.name} {w} wire: y symbols that differ from JAX's bfloat16 codec: "
                  f"{share:.2e} (bar {SYMBOL_SHARE_TOL}); bytes "
                  f"{[sum(map(len, s)) for s in enc[w]['strings']]}, JAX "
                  f"{[sum(map(len, s)) for s in jenc[w]['strings']]}")
            assert share <= SYMBOL_SHARE_TOL, w



class OneShotBf16Twin(MaskedBf16Twin):
    """:class:`MaskedBf16Twin` of stf3 and stf4, with their coder's
    invariant under the policy."""

    @pytest.mark.parametrize("i", [0, 1, 2, 3])
    def test_context_rows_ignore_the_rows_after_them_bf16(self, twin, i):
        """The context pass's rows <= i bit-identical after the buffer's rows
        >= i are zeroed or set to 1, the tokens in bfloat16 as the encoder
        forms them."""
        tm = twin["tm"]
        codec = Stf3Codec(tm)
        tnn.set_activation_dtype(BF16)
        with torch.no_grad():
            y_tok, m_tok, s_tok = codec._encode(torch.from_numpy(twin["x"]))["tokens"]
            assert y_tok.dtype == m_tok.dtype == BF16
            base = tm.causal_mu_scale(m_tok, s_tok, y_tok)
            for fill in (0.0, 1.0):
                buf = y_tok.clone()
                buf[:, i:] = fill
                got = tm.causal_mu_scale(m_tok, s_tok, buf)
                assert all(torch.equal(a[:, :i + 1], b[:, :i + 1]) for a, b in zip(got, base))


# --- each module against its flax counterpart ------------------------------------------


def _flax_params(module, *args, seed=0, **kw) -> dict:
    """numpy parameters at the shapes of ``module``'s init: kernels fan-in
    scaled, LayerNorm near one, small biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))["params"]

    def draw(path, leaf):
        parent, name = (getattr(p, "key", "") for p in path[-2:])
        n = rng.standard_normal(leaf.shape, dtype=np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(leaf.shape[:-1]))
        if parent.startswith("LayerNorm"):
            return 1.0 + 0.1 * n if name == "scale" else 0.05 * n
        return 0.01 * n

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _masks(L: int) -> dict:
    """The masks the models use, each kind at L: stf3's block mask over
    [L/2 hyper | L/2 y] (float), stf4's strict tril (float, row 0 all
    masked), the causal tril (bool)."""
    N = L // 2
    vis = np.zeros((L, L), bool)
    vis[:N, :N] = True
    vis[N:] = np.tril(np.ones((N, L), bool), N)
    return {"block": np.where(vis, 0.0, -1000.0).astype(np.float32),
            "strict": np.where(np.tril(np.ones((L, L)), -1) > 0, 0.0, -1000.0).astype(np.float32),
            "causal": np.tril(np.ones((L, L), bool))}


@pytest.mark.parametrize("mask", ["none", "block", "strict", "causal"])
@pytest.mark.parametrize("heads", [1, 2])
def test_plain_attention_matches_flax(mask, heads):
    x = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32)
    m = None if mask == "none" else _masks(12)[mask]
    jmod = jmc.PlainAttention(16, heads)
    params = _flax_params(jmod, jnp.asarray(x))
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      mask=None if m is None else jnp.asarray(m))
    tmod = tmc.PlainAttention(16, heads)
    tmod.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mask", ["block", "causal"])
def test_masked_context_model_matches_flax(mask):
    """Five blocks (no residual around the attention), stf3's masks."""
    x = np.random.default_rng(2).standard_normal((2, 12, 16)).astype(np.float32)
    m = _masks(12)[mask]
    jmod = jmc.MaskedContextModel(16)
    params = _flax_params(jmod, jnp.asarray(x), seed=3)
    want = jmod.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(m))
    tmod = tmc.MaskedContextModel(16)
    tmod.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("window,include_current", [(3, False), (3, True), (8, False),
                                                    (27, True)])
def test_causal_windows_match_jax(window, include_current):
    """The port's d-major windows (B, N, D, w) are JAX's (B, N, w, D)
    transposed, zero-padded at the front alike."""
    t = np.random.default_rng(4).standard_normal((2, 10, 6)).astype(np.float32)
    want = np.asarray(jmc._causal_windows(jnp.asarray(t), window, include_current))
    got = tmc._causal_windows(torch.from_numpy(t), window, include_current)
    np.testing.assert_array_equal(got.transpose(-1, -2).numpy(), want)


def test_stf4_fused_heads_match_jax():
    """stf4's fused heads with the reference's scramble (the unfold's
    d-major windows read row-major as an NCHW image), mu from the scale
    hyper windows and scale from the mean ones, through ``cc_mean_head``:
    within 1e-5 of JAX's, blocks flattened channel-major."""
    config = {**TINY, "causal": True, "sliding": 8}
    jm, variables, tm, _ = make_twin("stf4", config, seed=2)
    rng = np.random.default_rng(5)
    ctx, m_tok, s_tok = (rng.standard_normal((2, 16, 16)).astype(np.float32) for _ in range(3))
    want = jm.apply(variables, *map(jnp.asarray, (ctx, m_tok, s_tok)), method=jm._fused_heads)
    with torch.no_grad():
        got = tm._fused_heads(*map(torch.from_numpy, (ctx, m_tok, s_tok)))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 1, 4, 2, 3).reshape(2, 16, 16)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    # the scale head holds parameters and takes no part
    with torch.no_grad():
        for p in tm.cc_scale_head.parameters():
            p.mul_(2.0)
        again = tm._fused_heads(*map(torch.from_numpy, (ctx, m_tok, s_tok)))
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# --- the full-width models, the registry, the codec's checks ------------------------------

# parameters at the published widths: the JAX registry models' counts
# (jax.eval_shape of their init)
FULL_WIDTH_PARAMS = {"stf3": 92_551_383, "stf4": 135_549_687}


@pytest.mark.parametrize("name", ["stf3", "stf4"])
def test_full_width_eval_forward_matches_jax(name):
    """The registry's full-width model (embed 48, depths 2/2/6/2, M = 384,
    8 slices of 48, tokens of D = 768; stf4 with its sliding window of
    27) against its JAX twin on one 64 x 64 image (8 tokens), parameters
    drawn at ``jax.eval_shape``'s shapes, at the narrow twins' bars; the
    port's parameter count is the JAX model's."""
    x = _images(1, 64, seed=3)
    jcls, jkw = jax_models[name]
    jm = jcls(**jkw)
    variables = _params_from_numpy(jm, x, seed=4)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(variables["params"]))
    with torch.device("meta"):
        tm = tmodels.models[name][0]()
    tm = tm.to_empty(device="cpu").eval()
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    assert sum(p.numel() for p in tm.parameters()) == n_jax == FULL_WIDTH_PARAMS[name]
    assert (tm.token_dim, tm.slice_ch, tm.num_slices, tm.mask_win_size) == (768, 48, 8, 4)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, jnp.asarray(x))
    for a, b in [(out["x_hat"], ref["x_hat"])] + [(out["likelihoods"][k], ref["likelihoods"][k])
                                                  for k in "yz"]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL, atol=FORWARD_TOL)


@pytest.mark.parametrize("name", ["stf3", "stf4"])
def test_registry_holds_the_jax_defaults(name):
    """The port's registry builds JAX's class for each name at its defaults
    (``causal=False``; stf4's sliding window 27), on the card unless the
    CPU is asked for."""
    cls, kwargs = tmodels.models[name]
    jcls, jkwargs = jax_models[name]
    assert cls.__name__ == jcls.__name__ and kwargs == jkwargs == {}
    with torch.device("meta"):
        m = cls()
    assert m.causal is False and m.latent_dim == 384
    if name == "stf4":
        assert m.sliding == 27
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodels.create_model(name, **TINY)


def test_create_model_draws_the_dense_layers_at_fan_in_scale():
    """The context's dense layers are flax's default ``nn.Dense``
    (lecun_normal, std 1/sqrt(fan_in)); the Swin blocks' keep 0.02."""
    m = tmodels.create_model("stf3", device="cpu", seed=0, **TINY)
    qkv = m.maskedContextModel_mu.attn0.qkv.weight
    assert abs(float(qkv.detach().std()) * np.sqrt(qkv.shape[1]) - 1.0) < 0.15
    swin = m.g_a.layer0.block0.attn.qkv.weight
    assert abs(float(swin.detach().std()) - 0.02) < 0.005


def test_stf4_codec_needs_the_causal_model():
    """The reference stf4 mask lets token 0 see every token: Stf4Codec
    refuses it, takes ``causal=True``, and stf3 codes with either mask."""
    assert Stf4Codec is Stf3Codec
    with pytest.raises(ValueError, match="causal=True"):
        Stf4Codec(tmodels.create_model("stf4", device="cpu", **TINY, sliding=8))
    Stf4Codec(tmodels.create_model("stf4", device="cpu", **TINY, sliding=8, causal=True))
    Stf3Codec(tmodels.create_model("stf3", device="cpu", **TINY))
    with pytest.raises(ValueError, match="wire"):
        Stf3Codec(tmodels.create_model("stf3", device="cpu", **TINY), wire="scan")
