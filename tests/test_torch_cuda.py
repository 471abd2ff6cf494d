"""The port's CUDA kernels against their plain versions, on the card.

Runs only where there is a CUDA card (each test skips with its reason
elsewhere). This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX).
"""

import numpy as np
import pytest
import torch

from icm_tpu_torch.nn import window_attention as twa

pytestmark = pytest.mark.cuda

HEADS = 8
SHAPES = [(64, 24), (16, 40)]  # (N, D) of the WACNN window blocks
# f32: the same sums in another order; bf16: one ulp (2**-7 relative) of
# outputs up to ~2, from probabilities and outputs rounded to bf16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(W, N, D, n_cls, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((W, HEADS, N, D)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((n_cls, HEADS, N, N)).astype(np.float32)
    if n_cls > 1:
        bias[1:] += np.where(rng.random((n_cls - 1, 1, N, N)) < 0.3, -100.0, 0.0)
    cls = (np.arange(W) % n_cls).astype(np.int32)
    rng.shuffle(cls)
    tdt = getattr(torch, dtype)
    t = lambda a, dt: torch.from_numpy(a).to("cuda", dt)  # noqa: E731
    return (t(q, tdt), t(k, tdt), t(v, tdt), t(bias, torch.float32),
            torch.from_numpy(cls).cuda())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W,n_cls", [(512, 4), (100, 4), (7, 1)])
# the WACNN shapes, then a window of 7x7 (more threads than rows) and 2x2
# (fewer rows than a warp), at the head widths the kernel is built for
@pytest.mark.parametrize("N,D", SHAPES + [(49, 24), (4, 40)])
def test_window_attention_kernel_matches_plain(N, D, W, n_cls, dtype):
    _needs_card()
    ins = _inputs(W, N, D, n_cls, dtype, seed=W + N)
    before = twa.LAUNCHES
    out = twa.window_attention_cuda(*ins)
    torch.cuda.synchronize()
    assert twa.LAUNCHES == before + 1
    ref = twa.window_attention_reference(*ins)
    assert out.dtype == ins[0].dtype and out.shape == ins[0].shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=TOL[dtype])
    # no atomics: a second launch gives the same bits
    assert torch.equal(twa.window_attention_cuda(*ins), out)


def test_window_attention_wrapper_rejects_what_the_kernel_does_not_take():
    _needs_card()
    q, k, v, bias, cls = _inputs(8, 16, 40, 1, "float32", seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        twa.window_attention_cuda(q.transpose(2, 3), k, v, bias, cls)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        twa.window_attention_cuda(q.half(), k.half(), v.half(), bias, cls)
    with pytest.raises(ValueError, match="head width"):
        twa.window_attention_cuda(q[..., :20].contiguous(), k[..., :20].contiguous(),
                                  v[..., :20].contiguous(), bias, cls)
