"""``czigzag`` (``conditionalZigzag``, the cross-attention conditional
codec): icm_tpu_torch against the JAX package.

Narrow twins at ``tests/test_masked_czigzag.py``'s ``CZ_TINY`` (embed 8,
depths (1, 1, 1, 1), 2 slices x 2x2 zigzag = 8 steps of 32 channels,
sliding support 3 and a window of 3 blocks, so that the support slides
and the windows clamp at the tail), two images and a seeded ``up_x4`` of
their shape, parameters drawn with numpy at the shapes of the JAX twin's
init (``test_torch_stf._params_from_numpy``) and carried over with
``from_jax_params``. The codecs code at ``narrow`` 4, the port's taking
the JAX codec's tables. Each twin's tests run in a file of their own, so
that the suite's workers run them side by side:

- ``test_torch_czigzag_twin.py`` (:class:`CzigzagTwin`, 2 x 64 x 64): the
  eval forward within 1e-4, the host, device and scan wires round trip
  bit for bit, 0 y symbols off JAX's ``CzigzagCodec`` and both streams
  byte for byte with it on each wire (the scan wire's tier byte
  included), decoding across the two frameworks both ways, the scan wire
  graphed and launch by launch alike (on the CPU both run launch by
  launch), its y_hat within JAX's bar of the device wire's; the stacked
  context weights against JAX's ``stack_czigzag_params`` and
  ``from_jax_params`` of a ``scan_charm=True`` tree;
- ``test_torch_czigzag_padded.py`` (2 x 96 x 64: the last Swin stage and
  the hyper stacks at 6 x 4, padded to the window): the eval forward and
  the scan wire likewise;
- ``test_torch_czigzag_train.py``: one float64 training step of the port's
  one forward against each of JAX's (the unrolled loop, and
  ``scan_charm=True``: ``_CzigzagScanStep`` under ``nn.scan`` over the
  stacked tree), within 1e-6 of each gradient's max;
- ``test_torch_czigzag_bf16.py``: the bfloat16 policy's eval forward, a
  training step and both wires JAX runs under it, at
  ``tests/test_bf16.py``'s bars, and the scan wire refusing it (JAX's
  fails there).

One JAX codec serves all of a twin's wires
(``test_torch_stf_family.OnWire``), so that they share its compiled
per-slice functions. This file holds what the twins share and the tests
without a twin: the cross-attention modules against flax, the registry,
the widths on the path and the full-width model's eval forward (``slow``:
about a minute).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import CROSS_TOL
from test_torch_layers import _load, _perturb, _run_jax, _x
from test_torch_stf import _params_from_numpy
from test_torch_stf_family import OnWire, port_tables

from icm_tpu.models import models as jax_models
from icm_tpu.models.crc_codec import CzigzagCodec as JaxCzigzagCodec
from icm_tpu.nn import swin as jswin
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch.coding import WireFormatError
from icm_tpu_torch.coding.wire import WIRE_SCAN
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.models.crc_codec import CzigzagCodec
from icm_tpu_torch.nn import swin as tswin

torch.set_num_threads(2)

# tests/test_masked_czigzag.py's CZ_TINY
CZ_TINY = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
               patch_size=2, drop_path_rate=0.0, num_slices=2, max_support=3, support_num=3,
               hyper_depths=(1, 1), cc_widths=(24, 16))
# the codecs' narrowing: at 1 or less the JAX model at its own init codes only
# zero y symbols on these images
NARROW = 4.0
# the eval forward of the two frameworks: f32 sums in another order
FORWARD_TOL = 1e-4
# one float64 training step: the same function in another order of sums
GRAD_TOL = 1e-6
# the wires: (the codec's wire, scan_wire)
WIRES = {"host": ("host", False), "device": ("device", False), "scan": ("device", True)}


def images(size, seed: int = 0) -> tuple:
    """-> (x, up_x4): two seeded images of ``size`` (H, W) each."""
    rng = np.random.default_rng(seed)
    return tuple(rng.random((2, *size, 3)).astype(np.float32) for _ in range(2))


def make_twin(size=(64, 64), seed: int = 1):
    """-> (JAX model, its variables, the port's model with them, x, up_x4)."""
    x, up = images(size)
    jcls, jkw = jax_models["czigzag"]
    jm = jcls(**{**jkw, **CZ_TINY})
    variables = _params_from_numpy(jm, x, seed, up)
    tm = tmodels.create_model("czigzag", device="cpu", **CZ_TINY)
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return jm, variables, tm.eval(), x, up


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def jax_eval(jm, variables, x, up):
    return jax.jit(lambda v, a, b: jm.apply(v, a, b, training=False))(
        variables, jnp.asarray(x), jnp.asarray(up))


def port_codec(tm, wire: str, tables, **kw) -> CzigzagCodec:
    w, scan = WIRES[wire]
    return CzigzagCodec(tm, tables=tables, narrow=NARROW, wire=w, scan_wire=scan, **kw)


def train_noise(tm, B: int, size: int, scan: bool, dtype=np.float64, seed: int = 5) -> tuple:
    """-> (JAX's noise arrays, the port's) of one training forward of ``tm``
    on B ``size`` x ``size`` images, in the order both draw them: z (the
    bottleneck's (C, 1, n) layout), then each slice's y block (NHWC). JAX's
    ``scan_charm=True`` forward traces its step twice (once to build it),
    so one array stands for every slice there (``scan``), and the port is
    handed that array for each."""
    rng = np.random.default_rng(seed)
    zs = hb = size // 32  # z's side; a zigzag block's (y's at /16, halved)

    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(dtype)

    z = u(tm.entropy_bottleneck.channels, 1, B * zs * zs)
    ys = [u(B, hb, hb, tm.slice_ch) for _ in range(tm.ctx_slices)]
    if scan:
        return [z, ys[0], ys[0]], [z] + [ys[0]] * tm.ctx_slices
    return [z] + ys, [z] + ys


def pytest_generate_tests(metafunc):
    """A twin class's ``wire`` argument over its ``wires``."""
    if "wire" in metafunc.fixturenames and metafunc.cls is not None:
        metafunc.parametrize("wire", metafunc.cls.wires)


class CzigzagTwin:
    """The eval forward and the wires of one twin; a file per twin
    subclasses it as ``Test<Twin>`` with ``size`` and ``wires`` set (and
    imports :func:`pytest_generate_tests`)."""

    size = (64, 64)
    wires = ("host", "device", "scan")

    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x, up = make_twin(self.size)
        xj, uj, xt, ut = jnp.asarray(x), jnp.asarray(up), torch.from_numpy(x), torch.from_numpy(up)
        codec = JaxCzigzagCodec(jm, variables, narrow=NARROW, wire="device", scan_wire=True)
        jc = {w: OnWire(codec, *WIRES[w]) for w in self.wires}
        tables = port_tables(codec.tables)
        port = {w: port_codec(tm, w, tables) for w in self.wires}
        return dict(jm=jm, variables=variables, tm=tm, x=x, up=up, jc=jc, tables=tables,
                    port=port, ref=jax_eval(jm, variables, x, up),
                    jenc={w: c.compress(xj, uj, return_debug=True) for w, c in jc.items()},
                    enc={w: c.compress(xt, ut, return_debug=True) for w, c in port.items()})

    def test_state_dict_covers_every_jax_parameter(self, twin):
        assert (len(jax.tree_util.tree_leaves(twin["variables"]["params"]))
                == len(twin["tm"].state_dict()))

    def test_eval_forward_matches_jax(self, twin):
        """x_hat and both likelihoods within 1e-4."""
        with torch.no_grad():
            out = twin["tm"](torch.from_numpy(twin["x"]), torch.from_numpy(twin["up"]))
        ref = twin["ref"]
        pairs = [(out["x_hat"], ref["x_hat"], "x_hat")] + [
            (out["likelihoods"][k], ref["likelihoods"][k], k) for k in "yz"]
        print(f"czigzag {self.size}: largest |port - JAX|:",
              {n: float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b, n in pairs})
        for a, b, n in pairs:
            assert a.shape == b.shape, n
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL,
                                       atol=FORWARD_TOL, err_msg=n)

    def _decompress(self, codec, enc, up):
        return codec.decompress(enc["strings"], *(enc[k] for k in CzigzagCodec.DECOMPRESS_KEYS),
                                up)

    def test_roundtrip_bitexact(self, twin, wire):
        enc = twin["enc"][wire]
        dec = self._decompress(twin["port"][wire], enc, torch.from_numpy(twin["up"]))
        assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
        assert dec["x_hat"].shape == twin["x"].shape
        assert float(dec["x_hat"].min()) >= 0 and float(dec["x_hat"].max()) <= 1

    def test_symbols_match_jax(self, twin, wire):
        """0 of the y symbols differ from the JAX codec's, some are nonzero,
        the decoder's x_hat is JAX's within the forward's bar, and z's grid
        is JAX's."""
        enc, jenc = twin["enc"][wire], twin["jenc"][wire]
        port_y, jax_y = nhwc(enc["y_hat"]), np.asarray(jenc["y_hat"])
        flipped = np.abs(port_y - jax_y) > 0.5
        syms = twin["port"][wire].symbols(torch.from_numpy(twin["x"]),
                                          torch.from_numpy(twin["up"]))["y_hat"]
        share = float(torch.cat([s.flatten() for s in syms]).ne(0).float().mean())
        print(f"czigzag {self.size} {wire}: y symbols off JAX's {flipped.sum()} of "
              f"{flipped.size}; nonzero {share:.1%}")
        assert flipped.sum() == 0 and share > 0
        np.testing.assert_allclose(port_y, jax_y, rtol=0, atol=CROSS_TOL)
        np.testing.assert_allclose(enc["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)
        assert tuple(enc["shape"]) == tuple(jenc["shape"])

    @pytest.mark.parametrize("stream", ["y", "z"])
    def test_streams_match_jax_byte_for_byte(self, twin, wire, stream):
        k = "yz".index(stream)
        got, want = twin["enc"][wire]["strings"][k], twin["jenc"][wire]["strings"][k]
        assert len(got) == len(want) == 2
        for b, (g, w) in enumerate(zip(got, want)):
            assert g == w, f"{stream} stream of image {b}: {len(g)} vs {len(w)} bytes"
        if wire == "scan" and stream == "y":  # JAX's scan-wire framing and tier byte
            assert all(g[3] == WIRE_SCAN and g[4] in (0, 1, 2) for g in got)

    def test_port_decodes_the_jax_streams(self, twin, wire):
        jenc = twin["jenc"][wire]
        dec = self._decompress(twin["port"][wire], jenc, torch.from_numpy(twin["up"]))
        np.testing.assert_allclose(nhwc(dec["y_hat"]), np.asarray(jenc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(dec["x_hat"].numpy(), np.asarray(jenc["x_hat"]), rtol=0,
                                   atol=FORWARD_TOL)

    def test_jax_decodes_the_port_streams(self, twin, wire):
        enc = twin["enc"][wire]
        dec = twin["jc"][wire].decompress(enc["strings"], enc["shape"], jnp.asarray(twin["up"]))
        np.testing.assert_allclose(np.asarray(dec["y_hat"]), nhwc(enc["y_hat"]), rtol=0,
                                   atol=CROSS_TOL)
        np.testing.assert_allclose(np.asarray(dec["x_hat"]), enc["x_hat"].numpy(), rtol=0,
                                   atol=FORWARD_TOL)


    def test_graphed_and_launched_scan_wire_agree(self, twin):
        """The scan wire with ``cuda_graphs=False``: the same blobs and the
        same y_hat / x_hat bits (on the CPU both run launch by launch), and
        its y_hat within JAX's bar of the device wire's floats
        (``tests/test_crc.py``: under 0.5% of elements more than 1e-2
        apart, median under 1e-4; the padded first conv sums in another
        order)."""
        xt, ut = torch.from_numpy(twin["x"]), torch.from_numpy(twin["up"])
        codec = port_codec(twin["tm"], "scan", twin["tables"], cuda_graphs=False)
        enc = codec.compress(xt, ut, return_debug=True)
        graphed = twin["enc"]["scan"]
        assert enc["strings"] == graphed["strings"]
        dec = self._decompress(codec, enc, ut)
        for k in ("y_hat", "x_hat"):
            assert torch.equal(enc[k], graphed[k]) and torch.equal(dec[k], graphed[k]), k
        dev = twin["port"].get("device") or port_codec(twin["tm"], "device", twin["tables"])
        d = (graphed["y_hat"] - dev.compress(xt, ut, return_debug=True)["y_hat"]).abs().numpy()
        print(f"czigzag {self.size}: scan vs device wire y_hat {np.mean(d > 1e-2):.4%} past "
              f"1e-2, median {np.median(d):.2e}")
        assert np.mean(d > 1e-2) < 0.005 and np.median(d) < 1e-4

    def test_stack_czigzag_params_matches_jax(self, twin):
        """The stacked, padded context weights bit for bit with JAX's
        ``stack_czigzag_params``, from the JAX tree and from the port's own
        state dict; unstacked again, the state dict itself."""
        from icm_tpu.models.czigzag import stack_czigzag_params as jax_stack
        from icm_tpu_torch.models.czigzag import stack_czigzag_params, unstack_czigzag_params

        tm = twin["tm"]
        # the float32 weights the port's state dict holds (the numpy draws'
        # kernels are float64; JAX's stacking makes them float32)
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                        jax.device_get(twin["variables"]["params"]))
        want = jax_stack(dict(params), twin["jm"])["czigzag_scan"]
        got = stack_czigzag_params(params, tm)["czigzag_scan"]
        port = stack_czigzag_params(tm, tm)["czigzag_scan"]
        assert set(got) == set(want) == set(port) == {"cc_mean", "cc_scale", "lrp"}
        for tag in want:
            assert set(want[tag]) == set(port[tag])
            for ln, p in want[tag].items():
                k = np.asarray(p["kernel"])
                np.testing.assert_array_equal(got[tag][ln]["kernel"].numpy(), k)
                np.testing.assert_array_equal(port[tag][ln]["weight"].numpy(),
                                              np.transpose(k, (0, 4, 3, 1, 2)))
                np.testing.assert_array_equal(port[tag][ln]["bias"].numpy(), p["bias"])
        back = unstack_czigzag_params({"czigzag_scan": port}, tm)
        sd = tm.state_dict()
        assert len(back) == 3 * tm.ctx_slices
        for name, layers in back.items():
            for ln, leaves in layers.items():
                for leaf, v in leaves.items():
                    assert torch.equal(v, sd[f"{name}.{ln}.{leaf}"]), (name, ln, leaf)


# --- the cross-attention modules against flax -----------------------------------------

# f32 on both sides, sums in another order (test_torch_swin.py's bars)
TOL_BLOCK = 5e-5


def _cross(module, params, x, ctx):
    with torch.no_grad():
        return _load(module, params)(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()


# (dim, heads, window, shift, H, W): whole windows with and without the
# shift, and a ragged 10 x 6 map padded to 12 x 8 before the shift
CROSS_BLOCKS = [(32, 2, 4, 0, 8, 8), (32, 2, 4, 2, 8, 8), (32, 2, 4, 2, 10, 6)]


@pytest.mark.parametrize("dim,heads,ws,ss,H,W", CROSS_BLOCKS)
def test_swin_block_cross(dim, heads, ws, ss, H, W):
    """q from x, k and v from a context of x's grid that enters without a
    LayerNorm and is padded and shifted with x; the context's own scale
    (x 3 and shifted) shows a norm applied to it."""
    x, ctx = _x((2, H, W, dim), 3), 3.0 * _x((2, H, W, dim), 4) + 1.0
    m = jswin.SwinBlockCross(dim=dim, num_heads=heads, window_size=ws, shift_size=ss)
    params = _perturb(m.init(jax.random.PRNGKey(1), x, ctx)["params"], 5)
    ref = np.asarray(m.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)))
    out = _cross(tswin.SwinBlockCross(dim, heads, ws, ss), params, x, ctx)
    assert out.shape == (2, H, W, dim)
    np.testing.assert_allclose(out, ref, atol=TOL_BLOCK, rtol=TOL_BLOCK)


@pytest.mark.parametrize("downsample", [None, "merge", "split"])
def test_basic_layer_cross(downsample):
    """Two blocks on one context at the stack's input resolution, then x
    merged or split."""
    x, ctx = _x((1, 8, 8, 32), 11), _x((1, 8, 8, 32), 12)
    m = jswin.BasicLayerCross(dim=32, depth=2, num_heads=2, window_size=4,
                              drop_path=[0.0, 0.1], downsample=downsample)
    params = _perturb(m.init(jax.random.PRNGKey(5), x, ctx)["params"], 13, scale=0.02)
    ref = np.asarray(m.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)))
    out = _cross(tswin.BasicLayerCross(32, 2, 4, [0.0, 0.1], downsample=downsample), params, x,
                 ctx)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL_BLOCK, rtol=TOL_BLOCK)


def test_cross_attention_on_the_normed_input_is_self_attention():
    """With the q and kv weights split from a self-attention block's qkv, the
    cross block on the context LayerNorm_0(x) gives the self-attention
    block's output, and on x itself another: the context enters k and v
    without the norm."""
    x = _x((1, 8, 8, 16), 21)
    m = jswin.SwinBlock(dim=16, num_heads=1, window_size=4, shift_size=2)
    params = jax.tree_util.tree_map(
        np.asarray, _perturb(m.init(jax.random.PRNGKey(2), x)["params"], 22))
    plain = _run_jax(m, params, x)
    qkv = params["attn"]["qkv"]
    cross = {**params, "attn": {**{k: v for k, v in params["attn"].items() if k != "qkv"},
                                "q": {"kernel": qkv["kernel"][:, :16], "bias": qkv["bias"][:16]},
                                "kv": {"kernel": qkv["kernel"][:, 16:],
                                       "bias": qkv["bias"][16:]}}}
    ln = params["LayerNorm_0"]
    mean, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
    normed = ((x - mean) / np.sqrt(var + 1e-5) * ln["scale"] + ln["bias"]).astype(np.float32)
    block = tswin.SwinBlockCross(16, 1, 4, 2)
    np.testing.assert_allclose(_cross(block, cross, x, normed), plain, atol=TOL_BLOCK,
                               rtol=TOL_BLOCK)
    assert not np.allclose(_cross(block, cross, x, x), plain, atol=1e-3)


# --- the full-width model, the registry, the codec's checks -------------------------------

# the JAX registry model's parameter count (jax.eval_shape of its init)
CZIGZAG_PARAMS = 242_694_711


def test_registry_holds_the_jax_defaults():
    """The registry's class at JAX's defaults: embed 48, depths 2/2/6/2,
    heads 3/6/12/24, window 4, M 384, 4 slices x 2x2 = 16 steps of 96,
    support 6 and windows of 6; JAX's parameter count; each slice's first
    conv 2 x 576 + 96 min(i, 6) wide (LRP 96 more); on the card unless the
    CPU is asked for."""
    cls, kwargs = tmodels.models["czigzag"]
    jcls, jkwargs = jax_models["czigzag"]
    assert cls.__name__ == jcls.__name__ == "conditionalZigzag" and kwargs == jkwargs == {}
    with torch.device("meta"):
        m = cls()
    assert sum(p.numel() for p in m.parameters()) == CZIGZAG_PARAMS
    assert (m.latent_dim, m.ctx_slices, m.slice_ch, m.max_support, m.cond_blocks) == (
        384, 16, 96, 6, 6)
    for i in (0, 6, 15):
        width = 1152 + 96 * min(i, 6)
        assert getattr(m, f"cc_mean_{i}").Conv_0.weight.shape[1] == width
        assert getattr(m, f"lrp_{i}").Conv_0.weight.shape[1] == width + 96
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmodels.create_model("czigzag", **CZ_TINY)


def test_attention_widths_on_the_path():
    """Window attention at head width 16 in every analysis and synthesis
    block (12 each), 96 in the 384-channel hyper stacks (``hyper_enc0``,
    ``hyper_dec_*1``: 14 blocks) and 48 in the 192-channel ones (10), all
    at window 4 (16 tokens): widths the kernel is built for."""
    from icm_tpu_torch.nn.window_attention import SUPPORTED_HEAD_DIMS

    with torch.device("meta"):
        m = tmodels.models["czigzag"][0]()
    widths = {}
    for name, mod in m.named_modules():
        if isinstance(mod, tnn.CrossWindowAttention):
            d = mod.dim // mod.num_heads
            widths[d] = widths.get(d, 0) + 1
            assert mod.window_size == (4, 4)
    assert widths == {16: 24, 96: 14, 48: 10}
    assert set(widths) <= set(SUPPORTED_HEAD_DIMS)
    assert not any(isinstance(mod, tnn.GDN) for mod in m.modules())


# about a minute on an 8-core CPU alone (the JAX init's shapes and the numpy
# draws 17 s, JAX's jit of the forward 32 s), more beside the suite's other
# workers: outside Tier-1 (-m slow -k czigzag)
@pytest.mark.slow
def test_full_width_eval_forward_matches_jax():
    """The registry's full-width czigzag against its JAX twin on one 64 x 64
    image and up_x4 (a 4 x 4 latent: the last stage and the hyper stacks
    padded to one window, z 2 x 2), parameters drawn at
    ``jax.eval_shape``'s shapes, at the narrow twins' bar."""
    x, up = (a[:1] for a in images((64, 64), seed=3))
    jcls, jkw = jax_models["czigzag"]
    jm = jcls(**jkw)
    variables = _params_from_numpy(jm, x, 4, up)
    ref = jax_eval(jm, variables, x, up)
    # 0.97 GB a copy of the weights: one copy at a time beside the state dict
    state = from_jax_params(variables["params"])
    del variables
    gc.collect()
    with torch.device("meta"):
        tm = tmodels.models["czigzag"][0]()
    tm = tm.to_empty(device="cpu").eval()
    tm.load_state_dict(state, strict=True)
    del state
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(up))
    err = {"x_hat": float(np.abs(out["x_hat"].numpy() - np.asarray(ref["x_hat"])).max())}
    err.update({k: float(np.abs(out["likelihoods"][k].numpy()
                                - np.asarray(ref["likelihoods"][k])).max()) for k in "yz"})
    print("full-width czigzag: largest |port - JAX|:", err)
    for a, b in [(out["x_hat"], ref["x_hat"])] + [(out["likelihoods"][k], ref["likelihoods"][k])
                                                  for k in "yz"]:
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FORWARD_TOL, atol=FORWARD_TOL)


def test_codec_checks_its_arguments():
    """A scan wire needs the device wire; a decode takes one wire an image
    of up_x4; device-wire streams do not decode on the scan wire."""
    tm = tmodels.create_model("czigzag", device="cpu", **CZ_TINY)
    with pytest.raises(ValueError, match="wire='device'"):
        CzigzagCodec(tm, scan_wire=True)
    with pytest.raises(ValueError, match="wire"):
        CzigzagCodec(tm, wire="scan")
    x, up = images((64, 64), seed=5)
    dev = CzigzagCodec(tm, narrow=NARROW, wire="device")
    enc = dev.compress(x, up)
    scan = CzigzagCodec(tm, tables=dev.tables, narrow=NARROW, wire="device", scan_wire=True)
    with pytest.raises(WireFormatError):
        scan.decompress(enc["strings"], enc["shape"], up)
    senc = scan.compress(x, up)
    with pytest.raises(ValueError, match="wires"):
        scan.decompress(senc["strings"], senc["shape"], up[:1])
