"""czigzag under the bfloat16 activation policy against the JAX package's
(``set_activation_dtype(jnp.bfloat16)``), at ``tests/test_bf16.py``'s bars
(``test_torch_bf16.py``), on the narrow twin's images at the JAX model's
own init (``tests/test_masked_czigzag.py``'s ``CZ_TINY``: its init codes
nonzero y symbols at ``narrow`` 4): the eval forward, one training step
and the host and device wires, and the scan wire refusing the policy, as
JAX's fails under it. x_hat is float32 in both packages (``end_to_rgb``
has no dtype) and the wires' y_hat bfloat16. JAX's cross attention rounds
its scores to bfloat16 before its float32 softmax; the port's kernel
keeps them float32 (ROADMAP Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import (BF16, BPP_RTOL, SYMBOL_SHARE_TOL, XHAT_MEAN_TOL,
                             _assert_bf16_close, _bpp)
from test_torch_czigzag import CZ_TINY, NARROW, images, nhwc, port_codec, train_noise
from test_torch_stf_family import on_wires, port_tables
from test_torch_train import _replay

from icm_tpu import nn as jnn
from icm_tpu.models import models as jax_models
from icm_tpu.models.crc_codec import CzigzagCodec as JaxCzigzagCodec
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.convert import from_jax_params


class TestCzigzagBf16:
    @pytest.fixture(autouse=True)
    def _reset_policies(self):
        yield
        jnn.set_activation_dtype(None)
        tnn.set_activation_dtype(None)

    @pytest.fixture(scope="class")
    def twin(self):
        x, up = images((64, 64))
        jcls, jkw = jax_models["czigzag"]
        jm = jcls(**{**jkw, **CZ_TINY})
        # jitted: the init traced op by op takes a minute
        params = jax.device_get(jax.jit(lambda a, b: jm.init(
            {"params": jax.random.PRNGKey(1), "noise": jax.random.PRNGKey(2)},
            a, b, training=False))(jnp.asarray(x), jnp.asarray(up))["params"])
        tm = tmodels.create_model("czigzag", device="cpu", **CZ_TINY)
        tm.load_state_dict(from_jax_params(params), strict=True)
        return dict(jm=jm, params=params, tm=tm.eval(), x=x, up=up)

    def test_eval_forward_bf16_matches_jax_bf16(self, twin):
        """x_hat float32 in both, every likelihood float32; x_hat and bpp
        against JAX's bfloat16 forward and the port's float32 one."""
        jm, tm, x, up = twin["jm"], twin["tm"], twin["x"], twin["up"]
        n_px = x.shape[0] * x.shape[1] * x.shape[2]
        xs, us = torch.from_numpy(x), torch.from_numpy(up)
        with torch.no_grad():
            f32 = tm(xs, us)
            tnn.set_activation_dtype(BF16)
            out = tm(xs, us)
        jnn.set_activation_dtype(jnp.bfloat16)
        ref = jax.jit(lambda p, a, b: jm.apply({"params": p}, a, b, training=False))(
            twin["params"], jnp.asarray(x), jnp.asarray(up))
        assert out["x_hat"].dtype == torch.float32 and np.asarray(ref["x_hat"]).dtype == np.float32
        assert {v.dtype for v in out["likelihoods"].values()} == {torch.float32}
        bpp = _bpp(out["likelihoods"], n_px)
        _assert_bf16_close("czigzag bf16: port against JAX", out["x_hat"], bpp, ref["x_hat"],
                           _bpp(ref["likelihoods"], n_px))
        _assert_bf16_close("czigzag bf16: port against port f32", out["x_hat"], bpp,
                           f32["x_hat"], _bpp(f32["likelihoods"], n_px))

    def test_train_step_bf16_matches_jax_bf16(self, twin, monkeypatch):
        """One training step under the policy (``make_train_step`` on an
        ``(x, up_x4)`` batch), the same noise in both: float32 gradients on
        float32 masters, all finite; loss, bpp and MSE within 5% of JAX's
        bfloat16 training forward and mean |x_hat difference| under 0.01;
        the aux loss within 1e-5."""
        jm, x, up = twin["jm"], twin["x"], twin["up"]
        tm = tmodels.create_model("czigzag", device="cpu", **CZ_TINY)
        tm.load_state_dict(twin["tm"].state_dict())
        jax_noise, port_noise = train_noise(tm, *x.shape[:2], False, np.float32)
        tr, jr = _replay(monkeypatch, jax_noise)
        tr.noise = port_noise
        key = jax.random.PRNGKey(0)
        jnn.set_activation_dtype(jnp.bfloat16)

        def terms(p):
            out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(up), training=True,
                           rngs={"noise": key, "dropout": key})
            rd = JaxRD(0.01)(out, jnp.asarray(x))
            return {**rd, "aux_loss": jm.apply({"params": p}, method=jm.aux_loss)}, out["x_hat"]

        ref_m, ref_x_hat = jax.jit(terms)(twin["params"])
        assert jr.i == len(jax_noise)

        tnn.set_activation_dtype(BF16)
        state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 1.0))
        seen = {}
        handle = tm.register_forward_hook(
            lambda m, a, out: seen.update(x_hat=out["x_hat"].detach()))
        metrics = ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))(
            state, (torch.from_numpy(x), torch.from_numpy(up)), torch.Generator())
        handle.remove()
        assert tr.i == len(port_noise)
        grads = [p.grad for p in tm.parameters()]
        assert all(g is not None for g in grads)
        assert {g.dtype for g in grads} == {p.dtype for p in tm.parameters()} == {torch.float32}
        assert all(torch.isfinite(g).all() for g in grads)
        got = {k: float(v) for k, v in metrics.items()}
        print(f"czigzag bf16 step: port {got}, JAX { {k: float(v) for k, v in ref_m.items()} }")
        for k in ("loss", "bpp_loss", "mse_loss"):
            assert got[k] == pytest.approx(float(ref_m[k]), rel=BPP_RTOL), k
        assert got["aux_loss"] == pytest.approx(float(ref_m["aux_loss"]), rel=1e-5)
        mean = float(np.abs(seen["x_hat"].float().numpy()
                            - np.asarray(ref_x_hat, np.float32)).mean())
        assert mean < XHAT_MEAN_TOL

    def test_codec_bf16_round_trips_on_both_wires(self, twin):
        """Compress and decompress under the policy on the host and the
        device wire: bit-exact, y_hat bfloat16 (as JAX's), the device wire's
        y_hat and x_hat the host wire's; mean |x_hat difference| under 0.01
        against float32 and against JAX's bfloat16 codec; under 2% of the y
        symbols off JAX's bfloat16 codec's on each wire."""
        tm, x, up = twin["tm"], twin["x"], twin["up"]
        xs, us = torch.from_numpy(x), torch.from_numpy(up)
        jnn.set_activation_dtype(jnp.bfloat16)  # before the JAX codec traces
        jc = on_wires(JaxCzigzagCodec(twin["jm"], {"params": twin["params"]}, narrow=NARROW,
                                      wire="device"))
        jenc = {w: c.compress(jnp.asarray(x), jnp.asarray(up), return_debug=True)
                for w, c in jc.items()}
        jnn.set_activation_dtype(None)
        tables = port_tables(jc["device"].tables)
        f32 = port_codec(tm, "host", tables).compress(xs, us, return_debug=True)
        tnn.set_activation_dtype(BF16)
        enc = {}
        for w in ("host", "device"):
            codec = port_codec(tm, w, tables)
            e = enc[w] = codec.compress(xs, us, return_debug=True)
            d = codec.decompress(e["strings"], e["shape"], us)
            assert e["y_hat"].dtype == BF16 and np.asarray(jenc[w]["y_hat"]).dtype == jnp.bfloat16
            assert torch.equal(d["y_hat"], e["y_hat"]) and torch.equal(d["x_hat"], e["x_hat"])
        for k in ("y_hat", "x_hat"):
            assert torch.equal(enc["device"][k], enc["host"][k]), k
        for against, ref in (("f32", f32["x_hat"]), ("JAX bf16", jenc["host"]["x_hat"])):
            mean = float(np.abs(enc["host"]["x_hat"].float().numpy()
                                - np.asarray(ref, np.float32)).mean())
            print(f"czigzag codec bf16 against {against}: mean |x_hat difference| {mean:.2e}")
            assert mean < XHAT_MEAN_TOL, against
        for w in ("host", "device"):
            flipped = np.abs(nhwc(enc[w]["y_hat"]) - np.asarray(jenc[w]["y_hat"], np.float32)) > 0.5
            nonzero = float((np.abs(nhwc(enc[w]["y_hat"])) > 0.5).mean())
            print(f"czigzag {w} wire: y symbols off JAX's bfloat16 codec {flipped.mean():.2e} "
                  f"(bar {SYMBOL_SHARE_TOL}); |y_hat| > 0.5 on {nonzero:.1%}; bytes "
                  f"{[sum(map(len, s)) for s in enc[w]['strings']]}, JAX "
                  f"{[sum(map(len, s)) for s in jenc[w]['strings']]}")
            assert flipped.mean() <= SYMBOL_SHARE_TOL, w

    def test_scan_wire_refuses_bf16(self, twin):
        """The port's scan wire takes float32 only: built or called under the
        policy it raises; JAX's scan wire fails under its bfloat16 policy:
        its chain's convolutions (float32 stacked weights) meet the
        bfloat16 conditioning and latents its scan-wire programs give it
        under the policy (here zeros of their shapes and dtype, so that the
        failing program is the only one traced)."""
        tm, x, up = twin["tm"], twin["x"], twin["up"]
        scan = port_codec(tm, "scan", None)
        tnn.set_activation_dtype(BF16)
        with pytest.raises(ValueError, match="float32"):
            port_codec(tm, "scan", None)
        with pytest.raises(ValueError, match="float32"):
            scan.compress(x, up)
        jnn.set_activation_dtype(jnp.bfloat16)
        jc = JaxCzigzagCodec(twin["jm"], {"params": twin["params"]}, narrow=NARROW,
                             wire="device", scan_wire=True)
        h = x.shape[1] // 32  # a zigzag block's side (y's at /16, halved)
        stack = jnp.zeros((tm.ctx_slices, x.shape[0], h, h, tm.slice_ch), jnp.bfloat16)
        with pytest.raises(TypeError, match="same dtypes"):
            jc._scanw.encode(stack, stack, stack, stack)
