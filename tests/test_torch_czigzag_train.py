"""One float64 training step of the czigzag narrow twin (2 x 64 x 64, x and
up_x4) against each of the JAX package's two training forwards: the
unrolled loop, and ``scan_charm=True`` (``_CzigzagScanStep`` under
``nn.scan`` over the stacked, zero-padded context tree). The port has one
forward for both; its step is ``train.make_train_step`` on an ``(x,
up_x4)`` batch. Both sides in float64 from the float32 weights the port's
state dict holds, the same noise replayed into both (JAX's scanned forward
traces its step twice, so one array stands for every slice there, and the
port is handed that array for each), stochastic depth 0:
RateDistortionLoss(0.01) and the aux loss within 1e-6, every gradient
within 1e-6 of its max (JAX's ``czigzag_scan`` gradients unstacked).

JAX's cross attention casts its scores to float32 for the softmax
(``icm_tpu/nn/swin.py:276``) where its self-attention promotes them
(``icm_tpu/nn/layers.py:280``: float64 stays float64), and the port's
keeps a float64 input float64 throughout. For the float64 step the JAX
module's ``jnp.float32`` reads as float64 (:class:`_PromotingJnp`): with
the float32 rounding of the scores alone the two steps' gradients part by
1.4e-6 of their max."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_czigzag import CZ_TINY, GRAD_TOL, make_twin, train_noise
from test_torch_stf_family_paths import _f64_port_params, _flat_port_nested
from test_torch_train import _close, _replay

from icm_tpu.models import models as jax_models
from icm_tpu.models.czigzag import stack_czigzag_params as jax_stack
from icm_tpu.nn import swin as jswin
from icm_tpu.train import RateDistortionLoss as JaxRD
from icm_tpu_torch import models as tmodels
from icm_tpu_torch import train as ttrain
from icm_tpu_torch.models.czigzag import unstack_czigzag_params


class _PromotingJnp(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64`` (the module
    docstring)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class TestCzigzagTrain:
    @pytest.fixture(scope="class")
    def twin(self):
        jm, variables, tm, x, up = make_twin()
        # the float32 weights the port's state dict holds
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                        jax.device_get(variables["params"]))
        return dict(jm=jm, params=params, tm=tm, x=x, up=up)

    @pytest.mark.parametrize("forward", ["unrolled", "scan_charm"])
    def test_train_step_matches_jax(self, twin, forward, monkeypatch):
        scan = forward == "scan_charm"
        jm, params = twin["jm"], twin["params"]
        if scan:
            jcls, jkw = jax_models["czigzag"]
            jm = jcls(**{**jkw, **CZ_TINY}, scan_charm=True)
            params = jax_stack(dict(params), twin["jm"])
        tm = tmodels.create_model("czigzag", device="cpu", **CZ_TINY)
        tm.load_state_dict(twin["tm"].state_dict())
        tm = tm.double()
        x64, up64 = (a.astype(np.float64) for a in (twin["x"], twin["up"]))
        jax_noise, port_noise = train_noise(tm, *x64.shape[:2], scan)
        tr, jr = _replay(monkeypatch, jax_noise)
        tr.noise = port_noise
        key = jax.random.PRNGKey(0)
        monkeypatch.setattr(jswin, "jnp", _PromotingJnp("jax.numpy"))

        def loss_fn(p):
            out = jm.apply({"params": p}, jnp.asarray(x64), jnp.asarray(up64), training=True,
                           rngs={"noise": key, "dropout": key})
            rd = JaxRD(0.01)(out, jnp.asarray(x64))
            aux = jm.apply({"params": p}, method=jm.aux_loss)
            return rd["loss"] + aux, {**rd, "aux_loss": aux}

        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
            (_, ref_m), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
            ref_m, ref_g = jax.device_get((ref_m, ref_g))
        assert jr.i == len(jax_noise)
        if scan:
            ref_g = dict(ref_g)
            ref_g.update(_flat_port_nested(unstack_czigzag_params(
                {"czigzag_scan": ref_g.pop("czigzag_scan")}, tm)))

        state = ttrain.TrainState(tm, ttrain.make_optimizer(tm, 1e-4, 1e-3, 0.0))
        seen = {}
        handle = tm.register_forward_hook(lambda m, a, out: seen.update(dtype=out["x_hat"].dtype))
        metrics = ttrain.make_train_step(tm, ttrain.RateDistortionLoss(0.01))(
            state, (torch.from_numpy(x64), torch.from_numpy(up64)), torch.Generator())
        handle.remove()
        assert tr.i == len(port_noise) and seen["dtype"] == torch.float64
        for k, v in metrics.items():
            _close(v.item(), ref_m[k], GRAD_TOL, k)
        ref_grads = _f64_port_params(ref_g, tm)
        assert set(ref_grads) == {n for n, _ in tm.named_parameters()}
        assert all(p.grad is not None for p in tm.parameters())
        worst = {n: _close(p.grad.numpy(), ref_grads[n], GRAD_TOL, n)
                 for n, p in tm.named_parameters()}
        print(f"czigzag {forward}: largest gradient error relative to its max:",
              max(worst.items(), key=lambda kv: kv[1]))
