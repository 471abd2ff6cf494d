"""The czigzag narrow twin on two 64 x 64 images (a 4 x 4 latent: 8 zigzag
steps of 2 x 2 blocks) against the JAX package: the tests of
``test_torch_czigzag.CzigzagTwin`` on the host, device and scan wires, and
the conversion of a JAX ``scan_charm=True`` tree."""

import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_czigzag import CZ_TINY, CzigzagTwin, pytest_generate_tests  # noqa: F401

from icm_tpu.models import models as jax_models
from icm_tpu.models.czigzag import stack_czigzag_params as jax_stack
from icm_tpu_torch.convert import from_jax_params


class TestCzigzag(CzigzagTwin):
    size = (64, 64)
    wires = ("host", "device", "scan")

    def test_device_wire_floats_are_the_host_wire_floats(self, twin):
        """The wires differ in their entropy coding only: the device wire's
        y_hat and x_hat equal the host wire's bit for bit."""
        host, dev = twin["enc"]["host"], twin["enc"]["device"]
        assert torch.equal(dev["y_hat"], host["y_hat"]) and torch.equal(dev["x_hat"], host["x_hat"])

    def test_from_jax_params_takes_a_czigzag_scan_tree(self, twin):
        """The tree of JAX's ``scan_charm=True`` model (its structure from
        ``jax.eval_shape``: the context stacks in one ``czigzag_scan``
        subtree) converts, given the model, to the state dict of the
        unrolled tree it was stacked from."""
        params = jax.device_get(twin["variables"]["params"])
        scanned = jax_stack(dict(params), twin["jm"])
        jcls, jkw = jax_models["czigzag"]
        real = jax.eval_shape(lambda: jcls(**{**jkw, **CZ_TINY}, scan_charm=True).init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
            jnp.asarray(twin["x"]), jnp.asarray(twin["up"]), training=False))["params"]
        assert (jax.tree_util.tree_map(jnp.shape, dict(real))
                == jax.tree_util.tree_map(jnp.shape, scanned))
        got, want = from_jax_params(scanned, model=twin["tm"]), from_jax_params(params)
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        with pytest.raises(ValueError, match="model"):
            from_jax_params(scanned)
