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
from test_torch_cnn_codec import CROSS_TOL
from test_torch_stf import _params_from_numpy
from test_torch_stf_family import port_tables
from test_torch_stf_family_paths import _f64_port_params
from test_torch_train import _close, _replay

from icm_tpu.models import masked_ctx as jmc
from icm_tpu.models import models as jax_models
from icm_tpu.models.masked_codec import Stf3Codec as JaxStf3Codec
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models import masked_ctx as tmc
from icm_tpu_torch.models.masked_codec import Stf3Codec, Stf4Codec

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
        jc = {w: JaxStf3Codec(jm, variables, wire=w) for w in ("host", "device")}
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
