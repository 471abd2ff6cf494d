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

from icm_tpu_torch.nn import gdn_fused as tgdn
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


def _inputs(W, N, D, n_cls, dtype, seed, heads=HEADS):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((W, heads, N, D)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((n_cls, heads, N, N)).astype(np.float32)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# 3 heads: W x 3 window-heads is not a multiple of the window-heads a block
# takes at once (4 at N <= 16, 2 at N <= 32), so the last item is partial;
# N = 4, 12, 25, 49 and 100 leave partial row and key tiles; N = 128 is
# the largest the kernel takes (16 key tiles per row)
@pytest.mark.parametrize("N,D", [(4, 40), (12, 24), (25, 40), (49, 24), (100, 40), (128, 24)])
@pytest.mark.parametrize("W", [1, 5, 333])
def test_window_attention_kernel_partial_items_and_tiles(N, D, W, dtype):
    _needs_card()
    ins = _inputs(W, N, D, 4 if W > 1 else 1, dtype, seed=W * N, heads=3)
    out = twa.window_attention_cuda(*ins)
    torch.cuda.synchronize()
    ref = twa.window_attention_reference(*ins)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=TOL[dtype])
    assert torch.equal(twa.window_attention_cuda(*ins), out)


def test_window_attention_kernel_bits_repeat_at_the_codec_shape():
    """Two launches at the codec's largest shape (more items than blocks, so
    each block walks several) give the same bits."""
    _needs_card()
    ins = _inputs(512, 64, 24, 4, "float32", seed=3)
    first = twa.window_attention_cuda(*ins)
    second = twa.window_attention_cuda(*ins)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_window_attention_kernel_out_of_range_class_gives_nan():
    _needs_card()
    q, k, v, bias, cls = _inputs(6, 16, 40, 2, "float32", seed=5)
    cls[2] = 2
    cls[4] = -1
    out = twa.window_attention_cuda(q, k, v, bias, cls)
    torch.cuda.synchronize()
    bad = torch.zeros(6, dtype=torch.bool, device="cuda")
    bad[[2, 4]] = True
    assert torch.isnan(out[bad]).all() and torch.isfinite(out[~bad]).all()


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


def test_window_attention_wrapper_rejects_unaligned_rows():
    """The kernel stages rows with 16-byte copies: a contiguous view that
    starts off a 16-byte boundary is refused, not read wrongly."""
    _needs_card()
    q, k, v, bias, cls = _inputs(8, 16, 40, 1, "float32", seed=0)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        twa.window_attention_cuda(shifted, k, v, bias, cls)


# GDN: y and dx absolutely (sums of C products in another order, values
# O(1)); dgamma and dbeta relative to their max (sums over every pixel)
GDN_TOL = {"y": 1e-5, "dx": 1e-5, "dgamma": 1e-4, "dbeta": 1e-4}


@pytest.fixture
def f32_reference():
    """The plain GDN version's 1x1 convolutions in full f32: cuDNN's default
    for f32 convolutions is TF32 (about 3 decimal digits)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _gdn_inputs(B, C, H, W, seed):
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(rng.standard_normal((B, C, H, W)).astype(np.float32)).cuda()
            for _ in range(2))
    gamma = torch.from_numpy(  # (C_out, C_in), not symmetric
        (0.1 * np.eye(C) + 0.01 * rng.random((C, C))).astype(np.float32)).cuda()
    beta = torch.from_numpy((1.0 + 0.1 * rng.random(C)).astype(np.float32)).cuda()
    return x, g, gamma, beta


@pytest.mark.parametrize("inverse", [False, True])
# the training step's GDN layers (8 x 192 at 128^2, 64^2, 32^2), a ragged
# pixel count (13 x 21 = 273: 9 tiles, the last partial), a small C, and
# more images than the backward's partial slots
@pytest.mark.parametrize("B,C,H,W", [(8, 192, 128, 128), (8, 192, 64, 64),
                                     (8, 192, 32, 32), (3, 192, 13, 21),
                                     (2, 12, 5, 7), (300, 16, 4, 8)])
def test_gdn_kernels_match_plain(B, C, H, W, inverse, f32_reference):
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(B, C, H, W, seed=B + C + H)
    before = (tgdn.FWD_LAUNCHES, tgdn.BWD_LAUNCHES)
    y = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
    dx, dgamma, dbeta = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert (tgdn.FWD_LAUNCHES, tgdn.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    y_ref = tgdn.gdn_forward_reference(x, gamma, beta, inverse)
    dx_ref, dgamma_ref, dbeta_ref = tgdn.gdn_backward_reference(g, x, gamma, beta, inverse)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=GDN_TOL["y"])
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=GDN_TOL["dx"])
    for got, ref, key in ((dgamma, dgamma_ref, "dgamma"), (dbeta, dbeta_ref, "dbeta")):
        scale = ref.abs().max()
        torch.testing.assert_close(got / scale, ref / scale, rtol=0, atol=GDN_TOL[key])


def test_gdn_backward_is_deterministic():
    """A fixed partition of rows and a fixed order of sums, no atomics: two
    launches give the same bits."""
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(8, 192, 64, 64, seed=1)
    first = tgdn.gdn_backward_cuda(g, x, gamma, beta, False)
    second = tgdn.gdn_backward_cuda(g, x, gamma, beta, False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inverse", [False, True])
# the backward's edges: C = 12, 13 and 200 are not multiples of the 16-row
# mma tile (13 also leaves gamma's rows off 16-byte boundaries, and 200 is
# past 192 channels, so gamma streams beside 16-pixel tiles); ragged pixel
# counts (1155 = 36 tiles of 32 and 3 pixels; 63 and 99, not multiples of
# 4); C = 512, the most the wrapper takes; 70 x 64 pixels, 140 chunks of
# 32 pixels for 64 partial slots
@pytest.mark.parametrize("B,C,H,W", [(4, 200, 16, 16), (2, 12, 33, 35), (5, 13, 7, 9),
                                     (1, 512, 9, 11), (70, 192, 8, 8)])
def test_gdn_backward_edges_match_plain_and_repeat(B, C, H, W, inverse, f32_reference):
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(B, C, H, W, seed=B * C + H)
    dx, dgamma, dbeta = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
    again = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
    torch.cuda.synchronize()
    dx_ref, dgamma_ref, dbeta_ref = tgdn.gdn_backward_reference(g, x, gamma, beta, inverse)
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=GDN_TOL["dx"])
    for got, ref, key in ((dgamma, dgamma_ref, "dgamma"), (dbeta, dbeta_ref, "dbeta")):
        scale = ref.abs().max()
        torch.testing.assert_close(got / scale, ref / scale, rtol=0, atol=GDN_TOL[key])
    for a, b in zip(again, (dx, dgamma, dbeta)):
        assert torch.equal(a, b)


def test_gdn_module_launches_both_kernels_in_training():
    _needs_card()
    from icm_tpu_torch.nn import GDN

    m = GDN(192, inverse=True).cuda()
    m.reset_parameters()
    x = torch.randn(2, 192, 7, 9, device="cuda", requires_grad=True)  # 63 pixels
    before = (tgdn.FWD_LAUNCHES, tgdn.BWD_LAUNCHES)
    m(x).square().sum().backward()
    torch.cuda.synchronize()
    assert (tgdn.FWD_LAUNCHES, tgdn.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(t).all() for t in (x.grad, m.gamma.grad, m.beta.grad))


def test_gdn_wrappers_reject_what_the_kernels_do_not_take():
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(1, 8, 3, 3, seed=0)
    with pytest.raises(ValueError, match="float32"):
        tgdn.gdn_forward_cuda(x.double(), gamma, beta, False)
    with pytest.raises(ValueError, match="contiguous"):
        tgdn.gdn_forward_cuda(x.transpose(2, 3), gamma, beta, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgdn.gdn_backward_cuda(g, x, gamma.cpu(), beta, False)
    with pytest.raises(ValueError, match="gamma must be"):
        tgdn.gdn_forward_cuda(x, gamma[:4], beta, False)
