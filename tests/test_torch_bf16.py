"""The bfloat16 activation policy of icm_tpu_torch against the JAX package's.

``icm_tpu_torch.nn.set_activation_dtype(torch.bfloat16)`` is the port of
``icm_tpu.nn.set_activation_dtype(jnp.bfloat16)``: convolutions and dense
layers in bfloat16 on float32 master parameters, LayerNorm, GDN's sums and
the entropy models in float32. Held here on the CPU, with the narrow twins
of ``test_torch_cnn_codec.py`` and ``test_torch_stf.py``:

- the policy itself: parameters stay float32 (after construction and
  after a training step), the likelihoods are float32, and ``None``
  restores the float32 forward bit for bit;
- the plain bfloat16 GDN against the JAX package's Pallas kernels in
  interpret mode (forward ``_pallas_fwd_impl`` and the backward of
  ``gdn_fused``), and the measured difference from the einsum forward
  that JAX's model runs;
- the eval forward, one training step and the codec on both wires under
  the policy, against JAX's under its policy and against the port's own
  float32, at ``tests/test_bf16.py``'s bars: mean |x_hat difference| under
  0.01 and bpp within 5%.

JAX's model runs its GDN as the einsum (rounding x^2, n and its root to
bfloat16) and on the CPU its attention in jnp (scores rounded to
bfloat16); the port follows the Pallas kernels (float32 inside, one
rounding at the output). So the models differ by more than float order in
bfloat16, and the bars are those of a bfloat16 run against float32.

The twins' parameters are drawn as their float32 tests draw them, except
the dense kernels: those take the JAX package's own init, a normal of
standard deviation 0.02 cut at two (``_trunc_dense``), on which
``tests/test_bf16.py``'s bars were set. The float32 tests scale them by
fan-in, so that attention sees O(1) logits; there every residual branch is
O(1), and bfloat16 rounding grows through the stf twin's blocks until
JAX's own bfloat16 x_hat strays from its float32 by several times the
bar: no bfloat16 model would meet it.

Both packages' policies are process-wide; a fixture resets them after
every test, and every JAX function is traced (jitted) inside the test
that sets the policy it runs under.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn_codec import NARROW as CNN_NARROW
from test_torch_cnn_codec import _params_from_numpy as cnn_params
from test_torch_stf import NARROW as STF_NARROW
from test_torch_stf import _params_from_numpy as stf_params
from test_torch_train import _replay

from icm_tpu import nn as jnn
from icm_tpu.models import WACNN as JaxWACNN
from icm_tpu.models import CharmCodec as JaxCharmCodec
from icm_tpu.models import SymmetricalTransFormer as JaxSTF
from icm_tpu.nn.gdn_pallas import _einsum_fwd, _pallas_fwd_impl, gdn_fused
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.nn import gdn_fused as tgdn

torch.set_num_threads(2)

BF16 = torch.bfloat16
# tests/test_bf16.py's bars: bfloat16 against float32 through the model
XHAT_MEAN_TOL = 0.01
BPP_RTOL = 0.05
# the narrow twins' y symbols that may differ from JAX's bfloat16 codec: a
# symbol is round(y - mu) of bfloat16 values of a few units, where an ulp is
# 2**-7 to 2**-6, so a one-ulp difference in y or mu (the two models round
# in different places, see the module docstring: a quarter to a third of
# the GDN outputs differ by an ulp) moves a symbol across its rounding
# boundary with a chance of about 1%; measured 0.2% (cnn) and 0.05% (stf).
# 2% leaves room for that and still catches a wrong channel, slice or
# layout (most symbols off)
SYMBOL_SHARE_TOL = 0.02

# x_hat under the policy, as in JAX: stf's last convolution (``to_rgb``,
# icm_tpu/models/stf.py:86) has no dtype, so it computes in float32
X_HAT_DTYPE = {"cnn": BF16, "stf": torch.float32}

MODELS = {
    "cnn": (JaxWACNN, CNN_NARROW, cnn_params),
    "stf": (JaxSTF, {**STF_NARROW, "drop_path_rate": 0.0}, stf_params),
}


@pytest.fixture(autouse=True)
def _reset_policies():
    yield
    jnn.set_activation_dtype(None)
    tnn.set_activation_dtype(None)


def _dense_kernels_as_initialized(params, seed):
    """Every dense kernel (the 2-D ``kernel`` leaves) redrawn as the JAX
    package initializes it: 0.02 times a normal cut at two."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", "") != "kernel" or leaf.ndim != 2:
            return leaf
        return (0.02 * np.clip(rng.standard_normal(leaf.shape), -2, 2)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module", params=sorted(MODELS))
def twins(request):
    """(name, JAX model, its variables, the port's model on the CPU, x)."""
    jax_cls, config, draw = MODELS[request.param]
    x = np.random.default_rng(0).random((2, 64, 64, 3)).astype(np.float32)
    jm = jax_cls(**config)
    variables = {"params": _dense_kernels_as_initialized(draw(jm, x, seed=1)["params"], 2)}
    tm = tmodels.create_model(request.param, device="cpu", **config)
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    return request.param, jm, variables, tm.eval(), x


def _bpp(likelihoods, n_px):
    return float(sum(-np.log2(np.asarray(v, np.float64)).sum() for v in likelihoods.values())
                 / n_px)


def _assert_bf16_close(name, x_hat, bpp, x_hat_ref, bpp_ref):
    """tests/test_bf16.py's bars; prints what was measured."""
    mean = float(np.abs(np.asarray(x_hat, np.float32) - np.asarray(x_hat_ref, np.float32)).mean())
    print(f"{name}: mean |x_hat difference| {mean:.2e}, bpp {bpp:.5f} against {bpp_ref:.5f} "
          f"({bpp / bpp_ref - 1:+.2e})")
    assert np.isfinite(np.asarray(x_hat, np.float32)).all()
    assert mean < XHAT_MEAN_TOL, name
    assert bpp == pytest.approx(bpp_ref, rel=BPP_RTOL), name


# --- the policy -----------------------------------------------------------------


def test_policy_keeps_float32_masters_and_none_restores_float32(twins):
    name, _, _, tm, x = twins
    xs = torch.from_numpy(x)
    with torch.no_grad():
        ref = tm(xs)
        tnn.set_activation_dtype(BF16)
        assert tnn.activation_dtype() is BF16
        out = tm(xs)
        tnn.set_activation_dtype(None)
        again = tm(xs)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert out["x_hat"].dtype == X_HAT_DTYPE[name]
    assert {v.dtype for v in out["likelihoods"].values()} == {torch.float32}
    assert torch.equal(again["x_hat"], ref["x_hat"])
    for k in ref["likelihoods"]:
        assert torch.equal(again["likelihoods"][k], ref["likelihoods"][k])
    # built under the policy, a model's parameters are float32 all the same
    tnn.set_activation_dtype(BF16)
    built = tmodels.create_model(name, device="cpu", **MODELS[name][1])
    assert {p.dtype for p in built.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="floating"):
        tnn.set_activation_dtype(torch.int32)


def test_layer_types_under_the_policy():
    """flax's promotion: conv, deconv and dense compute and return the
    policy dtype from a float32 input, the bias added after the product is
    rounded; LayerNorm returns float32 from a bfloat16 input (torch's own
    would return bfloat16)."""
    torch.manual_seed(0)
    conv, deconv = tnn.conv(3, 4, 3, 1), tnn.deconv(4, 3, 3, 2)
    dense, norm = tnn.Linear(4, 5), tnn.LayerNorm(4)
    x = torch.randn(1, 3, 8, 8)
    tnn.set_activation_dtype(BF16)
    assert conv(x).dtype == deconv(conv(x)).dtype == dense(torch.randn(2, 4)).dtype == BF16
    assert norm(torch.randn(2, 4).to(BF16)).dtype == torch.float32
    product = torch.nn.functional.conv2d(x.to(BF16), conv.weight.to(BF16), padding=1)
    assert torch.equal(conv(x), product + conv.bias.to(BF16).reshape(-1, 1, 1))


def test_parameter_casts_are_kept_until_a_parameter_changes():
    """Without autograd a layer casts its parameters once and reuses the
    casts, the bits of a cast per call, until a parameter changes in place
    (an assignment, an optimizer step) or the policy changes; under
    autograd it casts per call and the float32 master gets a float32
    gradient."""
    F = torch.nn.functional
    torch.manual_seed(0)
    conv, dense = tnn.conv(3, 4, 3, 1), tnn.Linear(4, 5)
    x, h = torch.randn(1, 3, 8, 8), torch.randn(2, 4)

    def fresh():  # the conv with casts made now
        y = F.conv2d(x.to(BF16), conv.weight.to(BF16), padding=1)
        return y + conv.bias.to(BF16).reshape(-1, 1, 1)

    tnn.set_activation_dtype(BF16)
    with torch.no_grad():
        assert torch.equal(conv(x), fresh())
        kept = conv._param_casts["weight"][1]
        assert torch.equal(conv(x), fresh())
        assert conv._param_casts["weight"][1] is kept
        conv.weight.mul_(2.0)
        assert torch.equal(conv(x), fresh())
        assert conv._param_casts["weight"][1] is not kept
        served = dense(h)
    out = dense(h)
    assert out.requires_grad and torch.equal(out.detach(), served)
    out.float().square().sum().backward()
    assert dense.weight.grad.dtype == dense.bias.grad.dtype == torch.float32
    torch.optim.SGD(dense.parameters(), lr=0.5).step()
    with torch.no_grad():
        want = F.linear(h.to(BF16), dense.weight.to(BF16)) + dense.bias.to(BF16)
        assert not torch.equal(want, served) and torch.equal(dense(h), want)
    tnn.set_activation_dtype(None)  # a policy change drops the kept casts
    assert "_param_casts" not in conv.__dict__ and "_param_casts" not in dense.__dict__


# --- the plain bfloat16 GDN against the Pallas kernels ---------------------------


def _bf16_ulp(ref):
    """One bfloat16 ulp at each value of ``ref`` (8 significant bits)."""
    ref = np.abs(np.asarray(ref, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(ref, 2.0 ** -126))) - 7)


def _gdn_bf16_inputs(C, seed):
    """x, g (2, 4, 5, C) and gamma (C_in, C_out) rounded to bfloat16 (40 rows:
    the Pallas kernels' tile of 8; 20 pixels an image, not a multiple of
    the card kernels' 4), beta float32; JAX layouts."""
    rng = np.random.default_rng(seed)
    r16 = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)  # noqa: E731
    x = r16(rng.standard_normal((2, 4, 5, C)).astype(np.float32))
    g = r16(rng.standard_normal((2, 4, 5, C)).astype(np.float32))
    gamma = r16((0.1 * np.eye(C) + 0.01 * rng.random((C, C))).astype(np.float32))
    beta = (0.5 + 0.1 * rng.random(C)).astype(np.float32)
    return x, g, gamma, beta


def _to_port(a):
    """NHWC bfloat16 values -> an NCHW bfloat16 tensor."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))
    return t.to(BF16)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("C", [192, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_bf16_gdn_matches_pallas_kernels(inverse, C):
    x, g, gamma, beta = _gdn_bf16_inputs(C, seed=C + inverse)
    tx, tg = _to_port(x), _to_port(g)
    tgamma = torch.from_numpy(np.ascontiguousarray(gamma.T)).to(BF16)
    tbeta = torch.from_numpy(beta)
    jx, jg, jgamma = (jnp.asarray(a, jnp.bfloat16) for a in (x, g, gamma))

    y = tgdn.gdn_forward_reference(tx, tgamma, tbeta, inverse)
    assert y.dtype == BF16
    ref = np.asarray(_pallas_fwd_impl(jx.reshape(-1, C), jgamma, jnp.asarray(beta).reshape(1, C),
                                      inverse, True), np.float32).reshape(x.shape)
    out = _nhwc(y)
    assert (np.abs(out - ref) <= _bf16_ulp(ref)).all()
    einsum = np.asarray(_einsum_fwd(jx.reshape(-1, C), jgamma,
                                    jnp.asarray(beta, jnp.bfloat16).reshape(1, C), inverse),
                        np.float32).reshape(x.shape)
    print(f"C={C} inverse={inverse}: plain bf16 forward against JAX's einsum forward "
          f"(x^2, n and its root in bfloat16): max |difference| {np.abs(out - einsum).max():.3e}, "
          f"mean {np.abs(out - einsum).mean():.3e}, share of values that differ "
          f"{(out != einsum).mean():.3f}")

    dx, dgamma, dbeta = tgdn.gdn_backward_reference(tg, tx, tgamma, tbeta, inverse)
    assert (dx.dtype, dgamma.dtype, dbeta.dtype) == (BF16, BF16, torch.float32)
    _, vjp = jax.vjp(lambda a, b, c: gdn_fused(a, b, c, inverse=inverse, interpret=True),
                     jx, jgamma, jnp.asarray(beta))
    rdx, rdgamma, rdbeta = (np.asarray(t, np.float32) for t in vjp(jg))
    assert (np.abs(_nhwc(dx) - rdx) <= _bf16_ulp(rdx)).all()
    for name, a, b in (("dgamma", dgamma.float().numpy().T, rdgamma),
                       ("dbeta", dbeta.numpy(), rdbeta)):
        assert np.abs(a - b).max() <= 1e-2 * np.abs(b).max(), name


# --- the models under the policy ---------------------------------------------------


def test_eval_forward_bf16_matches_jax_bf16(twins):
    name, jm, variables, tm, x = twins
    n_px = x.shape[0] * x.shape[1] * x.shape[2]
    xs = torch.from_numpy(x)
    with torch.no_grad():
        f32 = tm(xs)
        tnn.set_activation_dtype(BF16)
        out = tm(xs)
    jnn.set_activation_dtype(jnp.bfloat16)
    ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, jnp.asarray(x))
    assert str(ref["x_hat"].dtype) == str(X_HAT_DTYPE[name]).split(".")[1]
    bpp = _bpp({k: v.numpy() for k, v in out["likelihoods"].items()}, n_px)
    _assert_bf16_close(f"{name} port bf16 against JAX bf16", out["x_hat"].float(), bpp,
                       ref["x_hat"], _bpp(ref["likelihoods"], n_px))
    _assert_bf16_close(f"{name} port bf16 against port f32", out["x_hat"].float(), bpp,
                       f32["x_hat"], _bpp({k: v.numpy() for k, v in f32["likelihoods"].items()},
                                          n_px))


def test_train_step_bf16_matches_jax_bf16(twins, monkeypatch):
    """One training step under the policy, the same noise replayed into both
    (``test_torch_train.py``): float32 gradients on the float32 masters, all
    finite; loss, bpp and MSE within 5% of JAX's bfloat16 training forward
    and mean |x_hat difference| under 0.01; the aux loss (float32 on both
    sides, untouched by the policy) within 1e-5. The step leaves the
    masters float32."""
    name, jm, variables, _, x = twins
    config = MODELS[name][1]
    params = jax.device_get(variables["params"])
    rng = np.random.default_rng(5)
    M = config["M"] if name == "cnn" else 8 * config["embed_dim"]
    sc = M // config["num_slices"]
    noise = [rng.uniform(-0.5, 0.5, (config["hyper_enc_widths"][-1], 1, 2)).astype(np.float32)]
    noise += [rng.uniform(-0.5, 0.5, (2, 4, 4, sc)).astype(np.float32)
              for _ in range(config["num_slices"])]
    tr, jr = _replay(monkeypatch, noise)
    key = jax.random.PRNGKey(0)
    jnn.set_activation_dtype(jnp.bfloat16)

    def terms(p):
        out = jm.apply({"params": p}, jnp.asarray(x), training=True,
                       rngs={"noise": key, "dropout": key})
        rd = JaxRD(0.01)(out, jnp.asarray(x))
        return {**rd, "aux_loss": jm.apply({"params": p}, method=jm.aux_loss)}, out["x_hat"]

    ref_m, ref_x_hat = jax.jit(terms)(params)
    assert jr.i == len(noise)

    tnn.set_activation_dtype(BF16)
    tm = tmodels.create_model(name, device="cpu", **config)
    tm.load_state_dict(from_jax_params(params), strict=True)
    state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 1.0))
    seen = {}
    real_step = ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))

    def forward_hook(module, args, output):
        seen["x_hat"] = output["x_hat"].detach()

    handle = tm.register_forward_hook(forward_hook)
    metrics = real_step(state, torch.from_numpy(x), torch.Generator())
    handle.remove()
    assert tr.i == len(noise)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.float32}
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    got = {k: float(v) for k, v in metrics.items()}
    print(f"{name} bf16 step: port {got}, JAX { {k: float(v) for k, v in ref_m.items()} }")
    for k in ("loss", "bpp_loss", "mse_loss"):
        assert got[k] == pytest.approx(float(ref_m[k]), rel=BPP_RTOL), k
    assert got["aux_loss"] == pytest.approx(float(ref_m["aux_loss"]), rel=1e-5)
    mean = float(np.abs(seen["x_hat"].float().numpy() - np.asarray(ref_x_hat, np.float32)).mean())
    assert mean < XHAT_MEAN_TOL


def test_codec_bf16_round_trips_on_both_wires(twins):
    """Compress and decompress under the policy, on the host wire and the
    device wire: y_hat bit for bit, x_hat equal to the encoder's, the device
    wire's y_hat equal to the host wire's; bpp within 5% and mean |x_hat
    difference| under 0.01 of the float32 codec. The share of y symbols
    that differ from JAX's bfloat16 codec on the same weights and input is
    printed and held under SYMBOL_SHARE_TOL."""
    name, jm, variables, tm, x = twins
    xs = torch.from_numpy(x)
    f32 = tmodels.CharmCodec(tm).compress(xs, return_debug=True)
    tnn.set_activation_dtype(BF16)
    host = tmodels.CharmCodec(tm)
    enc = host.compress(xs, return_debug=True)
    dec = host.decompress(enc["strings"], enc["shape"])
    assert enc["y_hat"].dtype == BF16
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    wire = tmodels.DeviceWireCodec(tm, lanes_per_image=4)
    denc = wire.compress(xs, return_debug=True)
    ddec = wire.decompress(denc["strings"], denc["shape"])
    assert torch.equal(ddec["y_hat"], denc["y_hat"]) and torch.equal(ddec["x_hat"], denc["x_hat"])
    assert torch.equal(denc["y_hat"], enc["y_hat"])

    def bpp(e):
        return 8 * sum(len(s) for k in (0, 1) for s in e["strings"][k]) / x[..., 0].size

    _assert_bf16_close(f"{name} codec bf16 against f32", dec["x_hat"].float(), bpp(enc),
                       f32["x_hat"], bpp(f32))

    jnn.set_activation_dtype(jnp.bfloat16)  # before the JAX codec traces its programs
    jenc = JaxCharmCodec(jm, variables).compress(jnp.asarray(x), return_debug=True)
    port_y = enc["y_hat"].float().permute(0, 2, 3, 1).numpy()
    jax_y = np.asarray(jenc["y_hat"], np.float32)
    share = float((np.abs(port_y - jax_y) > 0.5).mean())
    print(f"{name}: y symbols that differ from JAX's bfloat16 codec: {share:.2e} of "
          f"{port_y.size} (bar {SYMBOL_SHARE_TOL})")
    assert share <= SYMBOL_SHARE_TOL
