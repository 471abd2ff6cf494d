"""The port's fused GDN (plain versions of the CUDA kernels) against the
JAX package's Pallas GDN kernels, run in interpret mode on the CPU.

``icm_tpu_torch.nn.gdn_fused`` works on NCHW with gamma as (C_out, C_in);
``icm_tpu.nn.gdn_pallas`` on rows of channels with gamma as (C_in, C_out).
The inputs are drawn with numpy and handed to both, gamma transposed; it is
never symmetric, so a transposed dgamma would show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu.nn import GDN as JaxGDN
from icm_tpu.nn.gdn_pallas import _pallas_fwd_impl, gdn_fused
from icm_tpu_torch.convert import from_jax_params
from icm_tpu_torch.nn import GDN
from icm_tpu_torch.nn import gdn_fused as tgdn

torch.set_num_threads(2)

# the JAX package's own tolerances for its kernels (tests/test_pallas_kernels.py):
# f32 sums of the same terms in another order. The forward is also held
# relative to the value (IGDN outputs here reach ~6, where 1e-6 is ~8 ulps);
# gradients are compared relative to each tensor's max, since dgamma and
# dbeta sum over all rows
TOL_FWD = 1e-6
TOL_GRAD = 1e-5


def _inputs(C, shape=(2, 8, 16), seed=0):
    """x (B, H, W, C), the cotangent g, gamma (C_in, C_out) not symmetric,
    beta (C,): the JAX layouts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, C)).astype(np.float32)
    g = rng.standard_normal((*shape, C)).astype(np.float32)
    gamma = (0.1 * np.eye(C) + 0.01 * rng.random((C, C))).astype(np.float32)
    beta = (0.5 + 0.1 * rng.random(C)).astype(np.float32)
    assert np.abs(gamma - gamma.T).max() > 1e-3
    return x, g, gamma, beta


def _port(x, gamma):
    """NHWC x -> NCHW tensor; JAX gamma (C_in, C_out) -> (C_out, C_in)."""
    return (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
            torch.from_numpy(np.ascontiguousarray(gamma.T)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("C", [192, 12, 256, 200])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_forward_matches_pallas_kernels(inverse, C):
    x, _, gamma, beta = _inputs(C)
    tx, tgamma = _port(x, gamma)
    out = _nhwc(tgdn.gdn_forward_reference(tx, tgamma, torch.from_numpy(beta), inverse))
    # gdn_fused's forward (the einsum inside its custom VJP) ...
    ref = np.asarray(gdn_fused(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                               inverse=inverse, interpret=True))
    np.testing.assert_allclose(out, ref, atol=TOL_FWD, rtol=TOL_FWD)
    # ... and the fused forward Pallas kernel itself
    rows = x.reshape(-1, C)
    fwd = np.asarray(_pallas_fwd_impl(jnp.asarray(rows), jnp.asarray(gamma),
                                      jnp.asarray(beta).reshape(1, C), inverse, True))
    np.testing.assert_allclose(out.reshape(-1, C), fwd, atol=TOL_FWD, rtol=TOL_FWD)


@pytest.mark.parametrize("C", [192, 12, 256, 200])
@pytest.mark.parametrize("inverse", [False, True])
def test_plain_backward_matches_pallas_kernel(inverse, C):
    x, g, gamma, beta = _inputs(C, seed=1)
    ref = jax.grad(
        lambda *a: jnp.sum(gdn_fused(*a, inverse=inverse, interpret=True) * g),
        argnums=(0, 1, 2),
    )(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tgamma = _port(x, gamma)
    tg, _ = _port(g, gamma)
    dx, dgamma, dbeta = tgdn.gdn_backward_reference(
        tg, tx, tgamma, torch.from_numpy(beta), inverse)
    got = (_nhwc(dx), dgamma.numpy().T, dbeta.numpy())  # dgamma back to (C_in, C_out)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, ref):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a / scale, np.asarray(b) / scale, atol=TOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("inverse", [False, True])
def test_autograd_function_matches_autodiff_of_plain_forward(inverse):
    """The autograd function's backward (the plain backward formulas) against
    PyTorch's own autodiff of the plain forward, in float64."""
    x, g, gamma, beta = _inputs(6, shape=(2, 3, 5), seed=2)
    tx, tgamma = _port(x, gamma)
    ins = [t.double().requires_grad_(True) for t in (tx, tgamma, torch.from_numpy(beta))]
    assert torch.autograd.gradcheck(
        lambda a, b, c: tgdn.gdn(a, b, c, inverse), ins)
    ours = torch.autograd.grad(tgdn.gdn(*ins, inverse).sum(), ins)
    auto = torch.autograd.grad(tgdn.gdn_forward_reference(*ins, inverse).sum(), ins)
    for a, b in zip(ours, auto):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_module_ragged_rows_matches_jax_einsum_path(inverse):
    """3 x 13 x 21 = 819 rows has no power-of-two tile, so the JAX module
    takes its einsum path; the port's module goes through its one route.
    Output and the gradients of every parameter (through the
    reparametrization) agree."""
    C = 24
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 13, 21, C)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    m = JaxGDN(C, inverse=inverse)
    params = jax.device_get(m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = {"beta": params["beta"] + 0.05 * rng.random(C).astype(np.float32),
              "gamma": params["gamma"] + 0.02 * rng.random((C, C)).astype(np.float32)}

    def loss(p, xx):
        return jnp.sum(m.apply({"params": p}, xx) * g)

    ref_y = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
    ref_dp, ref_dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    port = GDN(C, inverse=inverse)
    sd = from_jax_params({"GDN_0": params})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    y = port(tx)
    np.testing.assert_allclose(_nhwc(y), ref_y, atol=TOL_FWD, rtol=TOL_FWD)
    tgo = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2)))
    (y * tgo).sum().backward()
    ref_grads = from_jax_params({"GDN_0": jax.device_get(ref_dp)})
    for name, a, b in (("dx", _nhwc(tx.grad), np.asarray(ref_dx)),
                       ("beta", port.beta.grad.numpy(), ref_grads["GDN_0.beta"].numpy()),
                       ("gamma", port.gamma.grad.numpy(), ref_grads["GDN_0.gamma"].numpy())):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a / scale, b / scale, atol=TOL_GRAD, err_msg=name)


def test_cuda_wrappers_take_cuda_tensors_only():
    """The kernel wrappers raise on a CPU tensor (the plain version is the
    CPU path), and the CPU path counts no launch."""
    x, g, gamma, beta = _inputs(8, shape=(1, 2, 3))
    tx, tgamma = _port(x, gamma)
    tg, _ = _port(g, gamma)
    tb = torch.from_numpy(beta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgdn.gdn_forward_cuda(tx, tgamma, tb, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgdn.gdn_backward_cuda(tg, tx, tgamma, tb, False)
    before = (tgdn.FWD_LAUNCHES.copy(), tgdn.BWD_LAUNCHES.copy())
    tx.requires_grad_(True)
    tgdn.gdn(tx, tgamma, tb, True).sum().backward()
    assert (tgdn.FWD_LAUNCHES, tgdn.BWD_LAUNCHES) == before
    with pytest.raises(ValueError, match="no GDN path"):
        tgdn.gdn_forward(tx.detach().to("meta"), tgamma.to("meta"), tb.to("meta"), False)
