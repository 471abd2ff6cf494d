"""icm_tpu_torch window attention against the JAX package's Pallas kernel.

The port's plain version (the CPU path, and what the CUDA kernel is held
against on the card) is compared with ``window_attention_fused`` run in
Pallas interpret mode and with ``window_attention_reference``, at the two
WACNN shapes (N=64, D=24 and N=16, D=40; 8 heads), stf's (N=16, D=16)
and the zigzag family refiners' (N=16 and 64 at D=8, N=64 at D=16), with 1
and 4 window classes and a window count that is not a multiple of the
Pallas tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icm_tpu.nn import pallas_kernels as jpk
from icm_tpu_torch.nn import window_attention as twa

torch.set_num_threads(2)

HEADS = 8
# (N, D): g_a block 1 / g_s block 2; the 32x32x320 blocks; stf's blocks;
# the zigzag family's refiners (stf5 at window 4 and stf7 at window 8 over
# 32 channels, stf8 at window 8 over 64)
SHAPES = [(64, 24), (16, 40), (16, 16), (16, 8), (64, 8), (64, 16)]

# f32: both sides compute the same f32 sums in another order; scores are
# O(10), softmax rows sum to 1, so 1e-5 absolute is a few ulps of the output.
TOL_F32 = 1e-5
# bf16: the output is rounded to bf16 (8 bits of mantissa): one ulp at
# |out| < 2 is 2**-7 = 7.8e-3; a probability that lands on the other side
# of a bf16 rounding boundary moves the output by about the same amount.
TOL_BF16 = 2e-2
# bf16 against the reference, which rounds the *scores* to bf16 as well
# (its einsum has no f32 accumulator type). Measured at the seeds below:
# max error 1.2e-2 to 2.1e-2, against mean |out| of 0.23-0.38; the limit
# sits a little above.
TOL_BF16_REFERENCE = 3e-2


def _inputs(W, N, D, n_cls, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((W, HEADS, N, D)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((n_cls, HEADS, N, N)).astype(np.float32)
    if n_cls > 1:  # the shifted-window mask's -100 entries, folded per class
        bias[1:] += np.where(rng.random((n_cls - 1, 1, N, N)) < 0.3, -100.0, 0.0)
    cls = (np.arange(W) % n_cls).astype(np.int32)
    rng.shuffle(cls)
    return q, k, v, bias, cls


def _torch(q, k, v, bias, cls, dtype):
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return t(q), t(k), t(v), torch.from_numpy(bias), torch.from_numpy(cls)


def _jax(q, k, v, bias, cls, dtype):
    t = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return t(q), t(k), t(v), jnp.asarray(bias), jnp.asarray(cls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [16, 13])
@pytest.mark.parametrize("n_cls", [1, 4])
@pytest.mark.parametrize("N,D", SHAPES)
def test_plain_matches_pallas_kernel(N, D, n_cls, W, dtype):
    ins = _inputs(W, N, D, n_cls, seed=N + D + n_cls + W)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = twa.window_attention_reference(*_torch(*ins, tdt))
    assert out.dtype == tdt and out.shape == (W, HEADS, N, D)
    fused = jpk.window_attention_fused(*_jax(*ins, jdt), interpret=True)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(fused.astype(jnp.float32)), atol=tol)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D", SHAPES)
def test_plain_matches_jax_reference(N, D, dtype, seed):
    ins = _inputs(13, N, D, 4, seed=seed)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = twa.window_attention_reference(*_torch(*ins, tdt))
    ref = jpk.window_attention_reference(*_jax(*ins, jdt))
    tol = TOL_F32 if dtype == "float32" else TOL_BF16_REFERENCE
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=tol)


def test_model_entry_on_cpu_is_the_plain_version():
    ins = _torch(*_inputs(9, 16, 40, 4, seed=3), torch.float32)
    launches = twa.LAUNCHES.copy()
    out = twa.window_attention(*ins)
    torch.testing.assert_close(out, twa.window_attention_reference(*ins),
                               rtol=0, atol=0)
    assert twa.LAUNCHES == launches  # a CPU tensor never reaches the kernel


def test_gradients_match_jax():
    """Training path: autograd through the port's function equals
    jax.grad through the fused kernel's custom VJP (f32, 1e-5 as above;
    gradients are O(1) sums of N terms)."""
    ins = _inputs(6, 16, 8, 4, seed=11)
    tq, tk, tv, tb, tc = _torch(*ins, torch.float32)
    leaves = [t.requires_grad_(True) for t in (tq, tk, tv, tb)]
    (twa.window_attention(*leaves, tc) ** 2).sum().backward()

    q, k, v, b, c = _jax(*ins, jnp.float32)

    def loss(q, k, v, b):
        return jnp.sum(jpk.window_attention_fused(q, k, v, b, c, interpret=True) ** 2)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(q, k, v, b)
    for t, g in zip(leaves, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)


@pytest.mark.parametrize("bias_grad", [True, False])
def test_backward_sums_the_bias_gradient_by_class(bias_grad):
    """The training backward takes the bias gradient as one product of the
    windows' one-hot classes with the per-window gradient: it equals
    autograd of the plain version's gather (f32 sums of 9 windows in
    another order, 1e-5 as above); without a bias gradient it computes
    none."""
    ins = _torch(*_inputs(9, 16, 16, 4, seed=12), torch.float32)
    g = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (9, HEADS, 16, 16)).astype(np.float32))
    grads = {}
    for name, fn in (("port", twa.window_attention), ("plain", twa.window_attention_reference)):
        leaves = [t.clone().requires_grad_(True) for t in ins[:3]]
        bias = ins[3].clone().requires_grad_(bias_grad)
        fn(*leaves, bias, ins[4]).backward(g)
        grads[name] = [t.grad for t in leaves] + [bias.grad]
    for a, b in zip(grads["port"], grads["plain"]):
        if bias_grad or b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        else:
            assert a is None


@pytest.mark.parametrize("H,W,ws,ss", [(32, 32, 8, 4), (8, 8, 4, 2), (16, 16, 4, 0)])
def test_class_tables_match_jax(H, W, ws, ss):
    n_cls, cls = twa.window_class_map(H, W, ws, ss)
    j_n, j_cls = jpk.window_class_map(H, W, ws, ss)
    assert n_cls == j_n
    np.testing.assert_array_equal(cls, j_cls)
    np.testing.assert_array_equal(twa.class_masks(H, W, ws, ss),
                                  jpk.class_masks(H, W, ws, ss))


def test_cuda_wrapper_refuses_cpu_tensors():
    ins = _torch(*_inputs(4, 16, 40, 1, seed=0), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        twa.window_attention_cuda(*ins)
