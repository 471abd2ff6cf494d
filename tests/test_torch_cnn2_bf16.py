"""``cnn2`` under the bfloat16 activation policy against the JAX package's
(``icm_tpu.nn.set_activation_dtype(jnp.bfloat16)``), on the narrow twin of
``test_torch_cnn2.py`` with its dense kernels at the JAX package's own
init (``test_torch_bf16._dense_kernels_as_initialized``, on which
``tests/test_bf16.py``'s bars were set).

The policy reaches the codec only: ``icm_tpu/tasks`` takes no activation
dtype, and flax promotes the bfloat16 x_hat with the student's float32
kernels to float32, so JAX's student runs in float32 on a bfloat16 x_hat.
Held: x_hat bfloat16 and the student's outputs float32 on both sides; the
codec at ``tests/test_bf16.py``'s bars (mean |x_hat difference| under 0.01,
bpp within 5%) against JAX's bfloat16 forward and the port's own float32;
the port's student on JAX's bfloat16 x_hat within 1e-4 of JAX's, and on its
own x_hat equal to the student run alone in float32; one training step
(loss terms within 5% of JAX's, float32 gradients on the float32 masters,
none for the student); and the device wire's round trip under the policy
with ``decompress_detect`` detecting in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import BPP_RTOL, _assert_bf16_close, _bpp, _dense_kernels_as_initialized
from test_torch_cnn2 import FORWARD_TOL, TINY, images, make_twin
from test_torch_cnn2_train import train_noise
from test_torch_train import _replay

from icm_tpu import nn as jnn
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import nn as tnn
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.convert import from_jax_params

torch.set_num_threads(2)

BF16 = torch.bfloat16
STUDENT = ("Student_classification", "Student_regression")


@pytest.fixture(autouse=True)
def _reset_policies():
    yield
    jnn.set_activation_dtype(None)
    tnn.set_activation_dtype(None)


@pytest.fixture(scope="module")
def twin():
    jm, variables, _, x = make_twin()
    variables = {"params": _dense_kernels_as_initialized(variables["params"], 2),
                 "batch_stats": variables["batch_stats"]}
    tm = tmodels.create_model("cnn2", device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    return jm, variables, tm.eval(), x


def test_eval_forward_bf16_matches_jax_bf16(twin):
    jm, variables, tm, x = twin
    n_px = x.shape[0] * x.shape[1] * x.shape[2]
    xs = torch.from_numpy(x)
    with torch.no_grad():
        f32 = tm(xs)
        tnn.set_activation_dtype(BF16)
        out = tm(xs)
        jnn.set_activation_dtype(jnp.bfloat16)
        ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(variables, jnp.asarray(x))
        assert str(ref["x_hat"].dtype) == "bfloat16" and out["x_hat"].dtype == BF16
        for k in STUDENT:
            assert str(ref[k].dtype) == "float32" and out[k].dtype == torch.float32, k
        bpp = _bpp({k: v.numpy() for k, v in out["likelihoods"].items()}, n_px)
        _assert_bf16_close("cnn2 port bf16 against JAX bf16", out["x_hat"].float(), bpp,
                           ref["x_hat"], _bpp(ref["likelihoods"], n_px))
        _assert_bf16_close("cnn2 port bf16 against port f32", out["x_hat"].float(), bpp,
                           f32["x_hat"], _bpp({k: v.numpy() for k, v in
                                               f32["likelihoods"].items()}, n_px))
        # the student under the policy: float32 on the bfloat16 x_hat
        jax_x_hat = torch.from_numpy(np.asarray(ref["x_hat"], np.float32)).to(BF16)
        _, _, cls, reg, _ = tm.studentNet(jax_x_hat)
        for got, k in ((cls, STUDENT[0]), (reg, STUDENT[1])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref[k]), rtol=0,
                                       atol=FORWARD_TOL, err_msg=k)
        tnn.set_activation_dtype(None)
        alone = tm.studentNet(out["x_hat"].float())
        assert torch.equal(alone[2], out[STUDENT[0]]) and torch.equal(alone[3], out[STUDENT[1]])


def test_train_step_bf16_matches_jax_bf16(twin, monkeypatch):
    """The same noise replayed into both: loss, bpp and MSE within 5% of
    JAX's bfloat16 training forward, the aux loss (float32 on both sides)
    within 1e-5; the codec's gradients float32 and finite, the student's
    none; the masters float32."""
    jm, variables, _, x = twin
    noise = [a.astype(np.float32) for a in train_noise(*x.shape[:2])]
    tr, jr = _replay(monkeypatch, noise)
    key = jax.random.PRNGKey(0)
    jnn.set_activation_dtype(jnp.bfloat16)

    def terms(p):
        v = {"params": p, "batch_stats": variables["batch_stats"]}
        out = jm.apply(v, jnp.asarray(x), training=True, rngs={"noise": key, "dropout": key})
        return {**JaxRD(0.01)(out, jnp.asarray(x)), "aux_loss": jm.apply(v, method=jm.aux_loss)}

    ref_m = jax.jit(terms)(variables["params"])
    assert jr.i == len(noise)

    tnn.set_activation_dtype(BF16)
    tm = tmodels.create_model("cnn2", device="cpu", **TINY)
    tm.load_state_dict(from_jax_params(variables), strict=True)
    state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 1.0))
    metrics = ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))(
        state, torch.from_numpy(x), torch.Generator())
    assert tr.i == len(noise)
    codec = {n: p.grad for n, p in tm.named_parameters() if not n.startswith("studentNet.")}
    assert {g.dtype for g in codec.values()} == {torch.float32}
    assert all(torch.isfinite(g).all() for g in codec.values())
    assert all(p.grad is None for p in tm.studentNet.parameters())
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    got = {k: float(v) for k, v in metrics.items()}
    print(f"cnn2 bf16 step: port {got}, JAX { {k: float(v) for k, v in ref_m.items()} }")
    for k in ("loss", "bpp_loss", "mse_loss"):
        assert got[k] == pytest.approx(float(ref_m[k]), rel=BPP_RTOL), k
    assert got["aux_loss"] == pytest.approx(float(ref_m["aux_loss"]), rel=1e-5)


def test_device_wire_bf16_round_trips_and_detects(twin):
    """Under the policy: the device wire's y_hat and x_hat bit for bit and
    x_hat bfloat16, its bpp within 5% and x_hat within 0.01 of the float32
    wire's, and ``decompress_detect`` running the student in float32 on
    the bfloat16 x_hat."""
    _, _, tm, x = twin
    xs = torch.from_numpy(images())
    f32 = tmodels.DeviceWireCodec(tm, lanes_per_image=4).compress(xs, return_debug=True)
    tnn.set_activation_dtype(BF16)
    codec = tmodels.DeviceWireCodec(tm, lanes_per_image=4)
    enc = codec.compress(xs, return_debug=True)
    got = tmodels.decompress_detect(codec, enc["strings"], enc["shape"])
    assert torch.equal(got["y_hat"], enc["y_hat"]) and torch.equal(got["x_hat"], enc["x_hat"])
    assert got["x_hat"].dtype == BF16 and got["classification"].dtype == torch.float32

    def bpp(e):
        return 8 * sum(len(s) for k in (0, 1) for s in e["strings"][k]) / x[..., 0].size

    _assert_bf16_close("cnn2 device wire bf16 against f32", got["x_hat"].float(), bpp(enc),
                       f32["x_hat"], bpp(f32))
    assert len(got["detections"]) == 2
