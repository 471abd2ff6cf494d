"""One float64 training step of the ``cnn2`` narrow twin
(``test_torch_cnn2.TINY``, 2 x 64 x 64) against the JAX package's, as
``tools/train.py`` trains it: ``RateDistortionLoss(0.01)`` and the aux
loss, the student run in the forward (JAX's ``__call__`` runs it). Both
sides in float64 from the float32 weights the port's state dict holds, the
same noise replayed into both (``test_torch_train._replay``): the loss
terms and every codec gradient within 1e-6 of its max. No loss reads the
student, so its gradients are JAX's zeros and the port's None, and the
step moves neither its parameters nor its BatchNorm statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cnn2 import TINY, make_twin
from test_torch_stf_family_paths import _f64_port_params
from test_torch_train import _close, _replay

from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import train as ttrain

torch.set_num_threads(2)

# one float64 step: the same function in another order of sums
GRAD_TOL = 1e-6


def train_noise(B: int, size: int, seed: int = 5) -> list:
    """One training forward's noise, in the order both draw it: z (the
    bottleneck's (C, 1, n) layout), then each slice's y (NHWC)."""
    rng = np.random.default_rng(seed)
    zs, ys = size // 64, size // 16
    sc = TINY["M"] // TINY["num_slices"]
    noise = [rng.uniform(-0.5, 0.5, (TINY["hyper_enc_widths"][-1], 1, B * zs * zs))]
    return noise + [rng.uniform(-0.5, 0.5, (B, ys, ys, sc)) for _ in range(TINY["num_slices"])]


@pytest.fixture(scope="module")
def twin():
    jm, variables, tm, x = make_twin()
    # the float32 weights the port's state dict holds
    return jm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      jax.device_get(variables)), tm, x


def test_train_step_matches_jax(twin, monkeypatch):
    jm, variables, twin_tm, x = twin
    tm = tmodels.create_model("cnn2", device="cpu", **TINY)
    tm.load_state_dict(twin_tm.state_dict())
    tm = tm.double()
    x64 = x.astype(np.float64)
    noise = train_noise(*x.shape[:2])
    tr, jr = _replay(monkeypatch, noise)
    key = jax.random.PRNGKey(0)

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)

        def loss_fn(p):  # the loss of icm_tpu.train.steps.make_train_step
            v = {"params": p, "batch_stats": v64["batch_stats"]}
            out = jm.apply(v, jnp.asarray(x64), training=True, rngs={"noise": key, "dropout": key})
            rd = JaxRD(0.01)(out, jnp.asarray(x64))
            aux = jm.apply(v, method=jm.aux_loss)
            return rd["loss"] + aux, ({**rd, "aux_loss": aux}, out["Student_classification"])

        (_, (ref_m, ref_cls)), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        ref_m, ref_cls, ref_g = jax.device_get((ref_m, ref_cls, ref_g))
    assert jr.i == len(noise)

    before = {k: v.clone() for k, v in tm.state_dict().items()}
    # no clip: it would scale the gradients read below in place
    state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 0.0))
    seen = {}
    handle = tm.register_forward_hook(
        lambda m, a, out: seen.update(cls=out["Student_classification"].detach()))
    metrics = ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))(
        state, torch.from_numpy(x64), torch.Generator())
    handle.remove()
    assert tr.i == len(noise)
    # the student ran in the forward, in float64, as JAX's did
    assert seen["cls"].dtype == torch.float64
    _close(seen["cls"].numpy(), ref_cls, GRAD_TOL, "Student_classification")
    for k, v in metrics.items():
        _close(v.item(), ref_m[k], GRAD_TOL, k)

    ref_grads = _f64_port_params(ref_g, tm)
    assert set(ref_grads) == {n for n, _ in tm.named_parameters()}
    worst = {}
    for name, p in tm.named_parameters():
        if name.startswith("studentNet."):
            assert p.grad is None, name
            assert not ref_grads[name].any(), name
        else:
            worst[name] = _close(p.grad.numpy(), ref_grads[name], GRAD_TOL, name)
    print("cnn2: largest gradient error relative to its max:",
          max(worst.items(), key=lambda kv: kv[1]))
    # the step moved the codec and left the student (and its statistics) alone
    after = tm.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v) == k.startswith("studentNet."), k
