"""The port's CUDA kernels against their plain versions, on the card.

Runs only where there is a CUDA card (each test skips with its reason
elsewhere). This file imports nothing of JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX).
"""

import importlib.util
import json
import os
import pathlib
import re
import tempfile
from collections import Counter

import numpy as np
import pytest
import torch

from icm_tpu_torch.coding import device_rans as tdr
from icm_tpu_torch.entropy import EntropyTables
from icm_tpu_torch.entropy.base import pmf_to_quantized_cdf_np
from icm_tpu_torch.graphs import by_dtype
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
# the WACNN shapes, stf's (4x4 windows, head width 16), the zigzag family
# refiners' (head width 8 at windows of 4x4 and 8x8, 16 at 8x8), then a
# window of 7x7 (more threads than rows) and 2x2 (fewer rows than a warp),
# at the head widths the kernel is built for
@pytest.mark.parametrize("N,D", SHAPES + [(49, 24), (4, 40), (16, 16), (4, 16), (16, 8),
                                          (64, 8), (64, 16), (4, 8)])
def test_window_attention_kernel_matches_plain(N, D, W, n_cls, dtype):
    _needs_card()
    ins = _inputs(W, N, D, n_cls, dtype, seed=W + N)
    before = twa.LAUNCHES.copy()
    out = twa.window_attention_cuda(*ins)
    torch.cuda.synchronize()
    assert twa.LAUNCHES - before == Counter({(ins[0].dtype, D): 1})
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
@pytest.mark.parametrize("N,D", [(4, 40), (12, 24), (25, 40), (49, 24), (100, 40), (128, 24),
                                 (12, 16), (49, 16), (128, 16), (12, 8), (49, 8), (128, 8)])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# stf's four shapes at 2 x 512 px (4x4 windows, head width 16: 3, 6, 12
# and 24 heads), and a ragged window count with the shifted-window classes
@pytest.mark.parametrize("W,heads,n_cls", [(8192, 3, 4), (2048, 6, 4), (512, 12, 1),
                                           (128, 24, 4), (8191, 3, 4)])
def test_window_attention_kernel_at_stf_shapes(W, heads, n_cls, dtype):
    _needs_card()
    ins = _inputs(W, 16, 16, n_cls, dtype, seed=W + heads, heads=heads)
    out = twa.window_attention_cuda(*ins)
    torch.cuda.synchronize()
    ref = twa.window_attention_reference(*ins)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=TOL[dtype])
    assert torch.equal(twa.window_attention_cuda(*ins), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# the zigzag family's refiner launches at 2 x 512 px (4 heads over the slice:
# stf5 32 x 32 slices at window 4, stf7 at window 8, head width 8; stf6
# and stf8 16 x 16 zigzag blocks at windows 4 and 8, head width 16), their
# unshifted (1 class) and shifted (4) blocks, then ragged window counts
@pytest.mark.parametrize("W,N,D,n_cls", [(128, 16, 8, 1), (128, 16, 8, 4), (32, 64, 8, 1),
                                         (32, 64, 8, 4), (32, 16, 16, 4), (8, 64, 16, 1),
                                         (8, 64, 16, 4), (127, 16, 8, 4), (31, 64, 8, 4),
                                         (7, 64, 16, 4)])
def test_window_attention_kernel_at_the_family_shapes(W, N, D, n_cls, dtype):
    _needs_card()
    ins = _inputs(W, N, D, n_cls, dtype, seed=W + N + D, heads=4)
    out = twa.window_attention_cuda(*ins)
    torch.cuda.synchronize()
    ref = twa.window_attention_reference(*ins)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=TOL[dtype])
    assert torch.equal(twa.window_attention_cuda(*ins), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# the CRC family's widths at 2 x 512 px (and 8 x 256 px in training): D 32
# over MainCNNDecoder's 256-channel block (512 windows of 8 x 8), D 48 over
# every 384-channel block (128 of 4 x 4), D 96 over stf12's 768-channel
# decoder head (128 of 4 x 4), 8 heads, at 4 window classes and at 1, then
# ragged window counts (D 96 at every token bucket of the kernel)
@pytest.mark.parametrize("W,N,D,n_cls", [(512, 64, 32, 4), (512, 64, 32, 1), (128, 16, 48, 4),
                                         (128, 16, 48, 1), (100, 64, 32, 4), (37, 16, 48, 4),
                                         (5, 49, 32, 4), (3, 100, 48, 4),
                                         (128, 16, 96, 4), (128, 16, 96, 1), (37, 16, 96, 4),
                                         (7, 30, 96, 4), (5, 49, 96, 4), (3, 100, 96, 4)])
def test_window_attention_kernel_at_the_crc_shapes(W, N, D, n_cls, dtype):
    _needs_card()
    ins = _inputs(W, N, D, n_cls, dtype, seed=W + N + D + n_cls)
    before = twa.LAUNCHES.copy()
    out = twa.window_attention_cuda(*ins)
    torch.cuda.synchronize()
    assert twa.LAUNCHES - before == Counter({(ins[0].dtype, D): 1})
    ref = twa.window_attention_reference(*ins)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=TOL[dtype])
    assert torch.equal(twa.window_attention_cuda(*ins), out)


@pytest.mark.parametrize("N,D,heads", [(64, 24, 8), (16, 16, 3)])
def test_window_attention_bf16_backward_types(N, D, heads):
    """The model path's bfloat16 q, k and v with a float32 bias, through the
    kernel's forward and the autograd of its plain version: dq, dk and dv
    come back in bfloat16 and the bias gradient in float32, as JAX's
    ``_fused_bwd`` gives them; the bfloat16 launch is counted."""
    _needs_card()
    q, k, v, bias, cls = _inputs(40, N, D, 4, "bfloat16", seed=N + D, heads=heads)
    q, k, v, bias = (t.requires_grad_(True) for t in (q, k, v, bias))
    before = twa.LAUNCHES.copy()
    out = twa.window_attention(q, k, v, bias, cls)
    assert twa.LAUNCHES - before == Counter({(torch.bfloat16, D): 1})
    assert out.dtype == torch.bfloat16
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16
    assert bias.grad.dtype == torch.float32 and bias.grad.shape == bias.shape
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v, bias))


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
    before = (tgdn.FWD_LAUNCHES.copy(), tgdn.BWD_LAUNCHES.copy())
    y = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
    dx, dgamma, dbeta = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert (tgdn.FWD_LAUNCHES - before[0], tgdn.BWD_LAUNCHES - before[1]) == (
        Counter({(torch.float32, C): 1}), Counter({(torch.float32, C): 1}))
    y_ref = tgdn.gdn_forward_reference(x, gamma, beta, inverse)
    dx_ref, dgamma_ref, dbeta_ref = tgdn.gdn_backward_reference(g, x, gamma, beta, inverse)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=GDN_TOL["y"])
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=GDN_TOL["dx"])
    for got, ref, key in ((dgamma, dgamma_ref, "dgamma"), (dbeta, dbeta_ref, "dbeta")):
        scale = ref.abs().max()
        torch.testing.assert_close(got / scale, ref / scale, rtol=0, atol=GDN_TOL[key])


@pytest.mark.parametrize("kernel", ["forward", "backward"])
def test_gdn_kernels_are_deterministic(kernel):
    """A fixed partition of rows and a fixed order of sums, no atomics: two
    launches give the same bits."""
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(8, 192, 64, 64, seed=1)
    if kernel == "forward":
        first = (tgdn.gdn_forward_cuda(x, gamma, beta, False),)
        second = (tgdn.gdn_forward_cuda(x, gamma, beta, False),)
    else:
        first = tgdn.gdn_backward_cuda(g, x, gamma, beta, False)
        second = tgdn.gdn_backward_cuda(g, x, gamma, beta, False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("inverse", [False, True])
# the kernels' edges: C = 12, 13, 200 and 208 are not multiples of the
# 16-row mma tile (13 also leaves gamma's rows off 16-byte boundaries);
# 200, 208 and 224 are past 192 channels, so a two-block cluster holds
# gamma with the second block's last m-tiles padded; ragged pixel counts
# (1155 = 36 tiles of 32 and 3 pixels; 63, 99, 35 and 323, not multiples
# of 4); C = 512, the most the wrapper takes (the backward streams gamma
# beside 16-pixel tiles, the forward runs on the FMA units); 70 x 64
# pixels, 140 tiles of 32 for at most one block per SM, and 140 chunks of
# 32 pixels for 64 partial slots; 1 x 35 pixels, fewer tiles than SMs (and
# than clusters at 256 channels); one pixel; the serving path's 2 x 192 x
# 64^2
@pytest.mark.parametrize("B,C,H,W", [(4, 200, 16, 16), (2, 12, 33, 35), (5, 13, 7, 9),
                                     (1, 512, 9, 11), (70, 192, 8, 8), (1, 192, 5, 7),
                                     (2, 192, 64, 64), (2, 256, 128, 128), (3, 256, 13, 21),
                                     (8, 256, 64, 64), (2, 208, 17, 19), (2, 224, 16, 16),
                                     (1, 256, 5, 7), (1, 256, 1, 1)])
# C = 256: MainCNNDecoder's IGDN (icm_tpu/nn/factories.py:52,64-65) at its
# path's shapes, 2 x 512 px serving and 8 x 256 px training, and at a
# ragged pixel count
def test_gdn_kernels_edges_match_plain_and_repeat(B, C, H, W, inverse, f32_reference):
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(B, C, H, W, seed=B * C + H)
    y = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
    y_again = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
    dx, dgamma, dbeta = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
    again = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
    torch.cuda.synchronize()
    y_ref = tgdn.gdn_forward_reference(x, gamma, beta, inverse)
    dx_ref, dgamma_ref, dbeta_ref = tgdn.gdn_backward_reference(g, x, gamma, beta, inverse)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=GDN_TOL["y"])
    assert torch.equal(y_again, y)
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=GDN_TOL["dx"])
    for got, ref, key in ((dgamma, dgamma_ref, "dgamma"), (dbeta, dbeta_ref, "dbeta")):
        scale = ref.abs().max()
        torch.testing.assert_close(got / scale, ref / scale, rtol=0, atol=GDN_TOL[key])
    for a, b in zip(again, (dx, dgamma, dbeta)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,C,designs", [
    (torch.float32, 192, ("gdn_fwd_kernel_resident", "gdn_bwd_kernel_dx_resident",
                          "gdn_bwd_kernel_dgamma")),
    (torch.float32, 256, ("gdn_fwd_kernel_cluster", "gdn_bwd_kernel_dx_cluster",
                          "gdn_bwd_kernel_dgamma")),
    (torch.float32, 512, ("gdn_fwd_kernel_fma", "gdn_bwd_kernel_dx_streamed",
                          "gdn_bwd_kernel_dgamma")),
    (torch.bfloat16, 192, ("gdn_fwd_kernel_bf16", "gdn_bwd_kernel_dx_bf16",
                           "gdn_bwd_kernel_dgamma_bf16")),
    (torch.bfloat16, 256, ("gdn_fwd_kernel_bf16", "gdn_bwd_kernel_dx_bf16",
                           "gdn_bwd_kernel_dgamma_bf16")),
])
def test_gdn_launches_the_design_of_its_width(dtype, C, designs):
    """The kernels a launch at C channels runs, by their names in a
    profiler trace: in float32 at 192 the resident block's forward and dx,
    at 256 the two-block cluster's, at 512 the FMA forward and the streamed
    dx; in bfloat16 at 192 and 256 the bfloat16 design's forward, dx and
    dgamma; the fixed-order reduce at every width."""
    _needs_card()
    from torch.profiler import ProfilerActivity, profile

    x, g, gamma, beta = _gdn_inputs(2, C, 9, 11, seed=C)
    x, g, gamma = x.to(dtype), g.to(dtype), gamma.to(dtype)
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the profiler has lost a session's first records (chip_smoke.py's
        # profile_session): tiny kernels first
        for _ in range(64):
            pad.add_(1)
        torch.cuda.synchronize()
        for _ in range(3):  # a trace has dropped a kernel record now and then
            tgdn.gdn_forward_cuda(x, gamma, beta, True)
            tgdn.gdn_backward_cuda(g, x, gamma, beta, True)
        torch.cuda.synchronize()
    names = {re.search(r"gdn_\w+", e.name).group(0) for e in prof.events()
             if e.device_type.name == "CUDA" and "gdn_" in e.name}
    assert names == {*designs, "gdn_reduce_kernel"}


def test_gdn_module_launches_both_kernels_in_training():
    _needs_card()
    from icm_tpu_torch.nn import GDN

    m = GDN(192, inverse=True).cuda()
    m.reset_parameters()
    x = torch.randn(2, 192, 7, 9, device="cuda", requires_grad=True)  # 63 pixels
    before = (tgdn.FWD_LAUNCHES.copy(), tgdn.BWD_LAUNCHES.copy())
    m(x).square().sum().backward()
    torch.cuda.synchronize()
    assert (tgdn.FWD_LAUNCHES - before[0], tgdn.BWD_LAUNCHES - before[1]) == (
        Counter({(torch.float32, 192): 1}), Counter({(torch.float32, 192): 1}))
    assert all(torch.isfinite(t).all() for t in (x.grad, m.gamma.grad, m.beta.grad))


# bfloat16 y and dx against the plain version (float32 inside, rounded once
# at the end): a value on the other side of a rounding boundary moves by one
# ulp, 2**-8 to 2**-7 of it, so the bar is 2e-2 below 1 and 2e-2 relative
# above (IGDN outputs reach ~13); dgamma (rounded to bfloat16) and dbeta
# (float32) relative to their max
GDN_BF16_TOL = {"y": 2e-2, "dx": 2e-2, "dgamma": 1e-2, "dbeta": 1e-2}


def gdn_bf16_err(got, ref):
    """max |got - ref| / max(1, |ref|), elementwise, in float32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


@pytest.mark.parametrize("inverse", [False, True])
# the training step's 192 channels and its smallest map; C = 12 and 13
# (not multiples of the 16-row tile; 13 leaves gamma's rows unaligned), 200
# (its last m-tiles padded), 512 (gamma streamed, the forward on the FMA
# units), 256 (the CRC decoder's IGDN, at its training and serving shapes);
# ragged pixel counts (273 = 13 x 21, 35, 63 and 99: not multiples of 8,
# so the loads take one value at a time). `spread`: x from 2^-64 to 2^8
# in magnitude, so that the squares' lo pieces reach bfloat16's subnormals
# and below, next to squares up to 2^16
@pytest.mark.parametrize("B,C,H,W,spread", [
    (8, 192, 32, 32, False), (3, 192, 13, 21, False), (2, 12, 33, 35, False),
    (5, 13, 7, 9, False), (4, 200, 16, 16, False), (2, 256, 64, 64, False),
    (3, 256, 13, 21, False), (1, 512, 9, 11, False), (2, 256, 128, 128, False),
    (2, 192, 32, 32, True), (2, 256, 16, 16, True)])
def test_gdn_bf16_kernels_match_plain_and_repeat(B, C, H, W, spread, inverse, f32_reference):
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(B, C, H, W, seed=B + C + W)
    if spread:
        rng = np.random.default_rng(C + W)
        x = x * torch.from_numpy(np.exp2(rng.uniform(-64, 8, x.shape)).astype(np.float32)).cuda()
    x, g, gamma = x.bfloat16(), g.bfloat16(), gamma.bfloat16()
    before = (tgdn.FWD_LAUNCHES.copy(), tgdn.BWD_LAUNCHES.copy())
    y = tgdn.gdn_forward_cuda(x, gamma, beta, inverse)
    grads = tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert (tgdn.FWD_LAUNCHES - before[0], tgdn.BWD_LAUNCHES - before[1]) == (
        Counter({(torch.bfloat16, C): 1}), Counter({(torch.bfloat16, C): 1}))
    assert y.dtype == grads[0].dtype == grads[1].dtype == torch.bfloat16
    assert grads[2].dtype == torch.float32
    y_ref = tgdn.gdn_forward_reference(x, gamma, beta, inverse)
    refs = tgdn.gdn_backward_reference(g, x, gamma, beta, inverse)
    assert gdn_bf16_err(y, y_ref) <= GDN_BF16_TOL["y"]
    assert gdn_bf16_err(grads[0], refs[0]) <= GDN_BF16_TOL["dx"]
    for got, ref, key in zip(grads[1:], refs[1:], ("dgamma", "dbeta")):
        got, ref = got.float(), ref.float()
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= GDN_BF16_TOL[key], key
    assert torch.equal(tgdn.gdn_forward_cuda(x, gamma, beta, inverse), y)
    for a, b in zip(tgdn.gdn_backward_cuda(g, x, gamma, beta, inverse), grads):
        assert torch.equal(a, b)


def test_gdn_module_bf16_launches_the_bf16_kernels():
    """Under the bfloat16 policy's types (x bfloat16, gamma rounded to it,
    beta float32) the module launches both bfloat16 builds; the gradients
    reach the float32 parameters in float32."""
    _needs_card()
    from icm_tpu_torch.nn import GDN

    m = GDN(192).cuda()
    m.reset_parameters()
    x = torch.randn(2, 192, 7, 9, device="cuda").bfloat16().requires_grad_(True)
    before = (tgdn.FWD_LAUNCHES.copy(), tgdn.BWD_LAUNCHES.copy())
    y = m(x)
    y.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (tgdn.FWD_LAUNCHES - before[0], tgdn.BWD_LAUNCHES - before[1]) == (
        Counter({(torch.bfloat16, 192): 1}), Counter({(torch.bfloat16, 192): 1}))
    assert y.dtype == x.grad.dtype == torch.bfloat16
    assert m.gamma.grad.dtype == m.beta.grad.dtype == torch.float32
    assert all(torch.isfinite(t).all() for t in (x.grad.float(), m.gamma.grad, m.beta.grad))


def test_policy_parameter_casts_follow_an_adam_step_on_the_card():
    """The bfloat16 casts a layer keeps between no-grad calls are made again
    after torch.optim.Adam's step on the card (its foreach update moves the
    parameters' versions), and match a cast made per call."""
    _needs_card()
    from icm_tpu_torch import nn as tnn

    torch.manual_seed(0)
    dense = tnn.Linear(64, 32).cuda()
    h = torch.randn(8, 64, device="cuda")
    tnn.set_activation_dtype(torch.bfloat16)
    try:
        with torch.no_grad():
            served = dense(h)
        dense(h).float().square().sum().backward()
        torch.optim.Adam(dense.parameters(), lr=0.1).step()
        with torch.no_grad():
            got = dense(h)
    finally:
        tnn.set_activation_dtype(None)
    want = torch.nn.functional.linear(h.bfloat16(), dense.weight.bfloat16()) + dense.bias.bfloat16()
    assert not torch.equal(got, served) and torch.equal(got, want)


def test_gdn_wrappers_reject_what_the_kernels_do_not_take():
    _needs_card()
    x, g, gamma, beta = _gdn_inputs(1, 8, 3, 3, seed=0)
    with pytest.raises(ValueError, match="float32"):
        tgdn.gdn_forward_cuda(x.double(), gamma, beta, False)
    with pytest.raises(ValueError, match="gamma must be"):
        tgdn.gdn_forward_cuda(x.bfloat16(), gamma, beta, False)
    with pytest.raises(ValueError, match="beta must be"):
        tgdn.gdn_forward_cuda(x.bfloat16(), gamma.bfloat16(), beta.bfloat16(), False)
    with pytest.raises(ValueError, match="g must be"):
        tgdn.gdn_backward_cuda(g, x.bfloat16(), gamma.bfloat16(), beta, False)
    with pytest.raises(ValueError, match="contiguous"):
        tgdn.gdn_forward_cuda(x.transpose(2, 3), gamma, beta, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgdn.gdn_backward_cuda(g, x, gamma.cpu(), beta, False)
    with pytest.raises(ValueError, match="gamma must be"):
        tgdn.gdn_forward_cuda(x, gamma[:4], beta, False)


# --- the device wire's rANS kernels: integer code, so byte for byte -----------
INT32_EXTREMES = np.array([2 ** 31 - 1, -(2 ** 31), 2 ** 20, -12345678], np.int64)


@pytest.fixture(scope="module")
def rans_tables():
    """Nine random CDF rows on the card; rows 0 and 1 have one coded
    symbol (length 3), the rest 2 to 40."""
    _needs_card()
    rng = np.random.default_rng(0)
    supports = [1, 1] + [int(s) for s in rng.integers(2, 41, size=7)]
    cdf = np.zeros((len(supports), max(supports) + 2), np.int32)
    for r, n in enumerate(supports):
        pmf = rng.random(n).astype(np.float32) + 1e-3
        pmf = pmf / pmf.sum() * (1.0 - 2 ** -8)
        row = pmf_to_quantized_cdf_np(np.concatenate([pmf, [1.0 - pmf.sum()]]).astype(np.float32))
        cdf[r, : row.shape[0]] = row
    host = EntropyTables(cdf, np.array(supports, np.int32) + 2,
                         rng.integers(-9, 3, size=len(supports)).astype(np.int32))
    assert host.cdf_length[0] == 3
    return host, tdr.build_device_tables(host, "cuda")


def _rans_payload(host, T, lanes, esc, seed):
    """(values, rows) int32 (T, lanes) on the card: values drawn from each
    row's own distribution, then about 1% escapes, none, or all of them
    int32 extremes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, host.num_distributions, size=(T, lanes))
    peek = rng.integers(0, 1 << 16, size=(T, lanes))
    sym = np.empty((T, lanes), np.int64)
    for r in range(host.num_distributions):
        at = rows == r
        L = int(host.cdf_length[r])
        sym[at] = np.clip(np.searchsorted(host.quantized_cdf[r, :L], peek[at], "right") - 1,
                          0, L - 3)
    values = sym + host.offset[rows]
    if esc == "some":
        values = np.where(rng.random((T, lanes)) < 0.01, rng.choice(INT32_EXTREMES, (T, lanes)),
                          values)
    elif esc == "all":
        values = rng.choice(INT32_EXTREMES, (T, lanes))
    return (torch.from_numpy(values.astype(np.int32)).cuda(),
            torch.from_numpy(rows.astype(np.int32)).cuda())


def _assert_same(got, want):
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("esc", ["none", "some", "all"])
# 1 lane; 65 and 2047 lanes, not multiples of the 64-thread block; 2048,
# the y path's lanes at 2 x 512^2; T = 1, 37 and 320 (y's steps)
@pytest.mark.parametrize("T,lanes", [(1, 1), (37, 1), (1, 65), (37, 65), (37, 2047),
                                     (320, 2048)])
def test_rans_kernels_match_plain(rans_tables, T, lanes, esc):
    host, tables = rans_tables
    values, rows = _rans_payload(host, T, lanes, esc, seed=T * lanes + len(esc))
    before = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
    enc = tdr.encode_lanes_cuda(values, rows, tables)
    _assert_same(enc, tdr.encode_lanes_reference(values, rows, tables))
    _assert_same(tdr.encode_lanes_cuda(values, rows, tables), enc)  # two launches
    buf, lengths, dest, raw, n_esc = enc
    if esc == "all":
        assert n_esc == T * lanes
    len_h = lengths.cpu().numpy()
    words = torch.from_numpy(
        tdr.assemble_streams(buf.cpu().numpy().view(np.uint16), len_h).view(np.int16)).cuda()
    off = torch.from_numpy(tdr.lane_offsets(len_h)).cuda()
    dec = tdr.decode_lanes_cuda(words, off, rows, tables)
    _assert_same(dec, tdr.decode_lanes_reference(words, off, rows, tables))
    _assert_same(tdr.decode_lanes_cuda(words, off, rows, tables), dec)
    assert torch.equal(dec[2], lengths)  # every word read
    assert torch.equal(tdr.fix_escapes(dec[0], dest, raw), values)
    torch.cuda.synchronize()
    assert (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES) == (before[0] + 2, before[1] + 2)


def test_rans_decode_continues_over_three_calls(rans_tables):
    host, tables = rans_tables
    values, rows = _rans_payload(host, 30, 130, "some", seed=3)
    buf, lengths, dest, raw, _ = tdr.encode_lanes_cuda(values, rows, tables)
    len_h = lengths.cpu().numpy()
    words = torch.from_numpy(
        tdr.assemble_streams(buf.cpu().numpy().view(np.uint16), len_h).view(np.int16)).cuda()
    off = torch.from_numpy(tdr.lane_offsets(len_h)).cuda()
    state = ptr = None
    parts = []
    for lo, hi in ((0, 7), (7, 8), (8, 30)):  # T = 7, 1 and 22
        got = tdr.decode_lanes_cuda(words, off, rows[lo:hi].contiguous(), tables, state, ptr)
        want = tdr.decode_lanes_reference(words, off, rows[lo:hi].contiguous(), tables,
                                          state, ptr)
        _assert_same(got, want)
        parts.append(got[0])
        _, state, ptr = got
    assert torch.equal(ptr, lengths)
    assert torch.equal(tdr.fix_escapes(torch.cat(parts), dest, raw), values)


def test_rans_wrappers_reject_what_the_kernels_do_not_take(rans_tables):
    host, tables = rans_tables
    values, rows = _rans_payload(host, 4, 8, "none", seed=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdr.encode_lanes_cuda(values.cpu(), rows, tables)
    with pytest.raises(ValueError, match="int32"):
        tdr.encode_lanes_cuda(values.long(), rows, tables)
    with pytest.raises(ValueError, match="contiguous"):
        tdr.encode_lanes_cuda(values.t().contiguous().t(), rows, tables)
    buf, lengths, _, _, _ = tdr.encode_lanes_cuda(values, rows, tables)
    words = buf.reshape(-1)
    off = torch.arange(8, dtype=torch.int32, device="cuda") * buf.shape[1]
    with pytest.raises(ValueError, match="int16"):
        tdr.decode_lanes_cuda(words.int(), off, rows, tables)
    with pytest.raises(ValueError, match="shape"):
        tdr.decode_lanes_cuda(words, off[:4], rows, tables)
    with pytest.raises(ValueError, match="both"):
        tdr.decode_lanes_cuda(words, off, rows, tables, state=off)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdr.decode_lanes_cuda(words, off.cpu(), rows, tables)


def test_rans_wrappers_count_no_launch_for_no_lanes(rans_tables):
    """The C entries launch nothing for zero lanes, so the wrappers count
    nothing."""
    _, tables = rans_tables
    empty = torch.zeros((5, 0), dtype=torch.int32, device="cuda")
    before = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
    buf, lengths, esc = tdr.encode_lanes_kernel(empty, empty, tables)
    vals, state, ptr = tdr.decode_lanes_cuda(
        torch.zeros(0, dtype=torch.int16, device="cuda"),
        torch.zeros(0, dtype=torch.int32, device="cuda"), empty, tables)
    torch.cuda.synchronize()
    assert buf.shape == (0, 7) and lengths.shape == (0,) and esc.shape == (5, 0)
    assert vals.shape == (5, 0) and state.shape == ptr.shape == (0,)
    assert (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES) == before


# --- the kernels' Hopper design: compact tables, reciprocals, the launch
# variants (tables in shared memory or read through L1; emissions kept in
# shared memory or written to the output rows) ------------------------------
DECODE_VARIANTS = {"smem": (256, True), "l1": (64, False)}
ENCODE_VARIANTS = {"smem": (16, True), "rows": (64, False)}


@pytest.fixture(scope="module")
def real_tables():
    """The seeded full-width model's coding tables: the 64 Gaussian rows
    (lengths 5 to 3133) and the bottleneck's 192 rows."""
    _needs_card()
    from icm_tpu_torch.models import build_codec_tables, create_model

    tables = build_codec_tables(create_model("cnn", device="cuda", seed=0))
    host = {"gaussian": tables.gaussian, "bottleneck": tables.bottlenecks["entropy_bottleneck"]}
    return {k: (h, tdr.build_device_tables(h, "cuda")) for k, h in host.items()}


def _tables(which, real_tables, rans_tables):
    return rans_tables if which == "fixture" else real_tables[which]


@pytest.mark.parametrize("variant", sorted(DECODE_VARIANTS))
@pytest.mark.parametrize("which", ["gaussian", "bottleneck", "fixture"])
def test_rans_decode_step_every_row_and_peek(real_tables, rans_tables, which, variant):
    """One lane for every (row, peek), one step, against the plain version:
    state (1 << 16) | peek, whose step reads a word unless the symbol's
    frequency is over 2^15, then a random upper half, whose step mostly
    reads none; word positions past the stream's end read its last word."""
    host, tables = _tables(which, real_tables, rans_tables)
    n = host.num_distributions
    rng = np.random.default_rng(n)
    lanes = n << 16
    rows = torch.arange(n, dtype=torch.int32, device="cuda").repeat_interleave(1 << 16)[None]
    peek = torch.arange(1 << 16, dtype=torch.int64, device="cuda").repeat(n)
    words = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, 4099).astype(np.int16)).cuda()
    off = torch.from_numpy(rng.integers(0, 4099, lanes).astype(np.int32)).cuda()
    ptr = torch.from_numpy(rng.integers(0, 8, lanes).astype(np.int32)).cuda()
    for upper in ("one", "random"):
        hi = (torch.ones_like(peek) if upper == "one"
              else torch.from_numpy(rng.integers(1, 1 << 16, lanes)).cuda())
        state = tdr._i32((hi << 16) | peek)
        got = tdr._decode_launch(words, off, rows, tables, state, ptr, DECODE_VARIANTS[variant])
        _assert_same(got, tdr.decode_lanes_reference(words, off, rows, tables, state, ptr))
        read = (got[2] - ptr).float().mean().item()
        assert (read > 0.5) if upper == "one" else (0 < read < 0.5)


def _every_symbol_payload(host, T, seed):
    """One lane for every (row, coded symbol) and every row's escape: the
    pair sits at a seeded step, the other steps are values drawn from
    random rows, and half the lanes code a run of the widest row's least
    likely symbol just before the pair, which drives the state towards
    2^32. -> (values, rows) int32 (T, lanes) on the card."""
    rng = np.random.default_rng(seed)
    n, L = host.num_distributions, host.cdf_length.astype(np.int64)
    pair_row = np.repeat(np.arange(n), L - 1)
    pair_sym = np.concatenate([np.arange(l - 1) for l in L])  # sym L-2: the escape
    lanes = pair_row.size
    rows = rng.integers(0, n, size=(T, lanes))
    peek = rng.integers(0, 1 << 16, size=(T, lanes))
    sym = np.empty((T, lanes), np.int64)
    for r in range(n):
        at = rows == r
        sym[at] = np.clip(np.searchsorted(host.quantized_cdf[r, :L[r]], peek[at], "right") - 1,
                          0, L[r] - 3)
    wide = int(np.argmax(L))
    freq = np.diff(host.quantized_cdf[wide, :L[wide]].astype(np.int64))[: L[wide] - 2]
    rare = int(np.argmin(freq))
    at = np.where(rng.random(lanes) < 1 / 3, 0, rng.integers(0, T - 9, lanes))
    run = rng.random(lanes) < 0.5
    for d in range(1, 9):  # coded (in reverse) just before the pair
        rows[at + d, np.arange(lanes)] = np.where(run, wide, rows[at + d, np.arange(lanes)])
        sym[at + d, np.arange(lanes)] = np.where(run, rare, sym[at + d, np.arange(lanes)])
    rows[at, np.arange(lanes)] = pair_row
    sym[at, np.arange(lanes)] = pair_sym
    values = sym + host.offset[rows]
    escape = sym == L[rows] - 2
    values = np.where(escape, rng.choice(INT32_EXTREMES, (T, lanes)), values)
    return (torch.from_numpy(values.astype(np.int32)).cuda(),
            torch.from_numpy(rows.astype(np.int32)).cuda())


@pytest.mark.parametrize("variant", sorted(ENCODE_VARIANTS))
@pytest.mark.parametrize("which", ["gaussian", "bottleneck", "fixture"])
def test_rans_encode_every_row_and_symbol(real_tables, rans_tables, which, variant):
    """Every (row, symbol) and every escape, at states across the coder's
    range, byte for byte with the plain version; the kernel's decode reads
    the values back."""
    host, tables = _tables(which, real_tables, rans_tables)
    values, rows = _every_symbol_payload(host, 48, seed=host.num_distributions)
    buf, lengths, esc = tdr._encode_launch(values, rows, tables, ENCODE_VARIANTS[variant])
    dest = esc.reshape(-1).nonzero()[:, 0]
    got = (buf, lengths, dest.to(torch.int32), values.reshape(-1)[dest], int(dest.numel()))
    _assert_same(got, tdr.encode_lanes_reference(values, rows, tables))
    # states past 2^31 were coded (the flushed hi word of the final state)
    assert int((buf[:, 0].long() & 0xFFFF).max()) >= 0x8000
    len_h = lengths.cpu().numpy()
    words = torch.from_numpy(
        tdr.assemble_streams(buf.cpu().numpy().view(np.uint16), len_h).view(np.int16)).cuda()
    off = torch.from_numpy(tdr.lane_offsets(len_h)).cuda()
    vals, _, ptr = tdr.decode_lanes_cuda(words, off, rows, tables)
    assert torch.equal(tdr.fix_escapes(vals, got[2], got[3]), values)
    assert torch.equal(ptr, lengths)


@pytest.mark.parametrize("stream", ["y", "z"])
def test_rans_kernels_at_bench_batch(real_tables, stream):
    """bench.py's batch, 32 images of 512^2: y 32768 lanes x 320 steps
    decoded in 10 continued launches, z 16384 x 24 in one; byte for byte
    with the plain versions, and two launches give the same bits."""
    which, T, lanes, n_launches = {"y": ("gaussian", 320, 32768, 10),
                                   "z": ("bottleneck", 24, 16384, 1)}[stream]
    host, tables = real_tables[which]
    values, rows = _rans_payload(host, T, lanes, "some", seed=lanes)
    enc = tdr.encode_lanes_cuda(values, rows, tables)
    _assert_same(enc, tdr.encode_lanes_reference(values, rows, tables))
    _assert_same(tdr.encode_lanes_cuda(values, rows, tables), enc)
    buf, lengths, dest, raw, _ = enc
    len_h = lengths.cpu().numpy()
    words = torch.from_numpy(
        tdr.assemble_streams(buf.cpu().numpy().view(np.uint16), len_h).view(np.int16)).cuda()
    off = torch.from_numpy(tdr.lane_offsets(len_h)).cuda()
    seg = T // n_launches

    def chain(fn):
        state = ptr = None
        out = []
        for i in range(n_launches):
            vals, state, ptr = fn(words, off, rows[i * seg:(i + 1) * seg], tables, state, ptr)
            out.append(vals)
        return [*out, state, ptr]

    dec = chain(tdr.decode_lanes_cuda)
    _assert_same(dec, chain(tdr.decode_lanes_reference))
    _assert_same(chain(tdr.decode_lanes_cuda), dec)
    assert torch.equal(dec[-1], lengths)
    assert torch.equal(tdr.fix_escapes(torch.cat(dec[:-2]), dest, raw), values)


def test_rans_encode_rows_past_shared_memory(rans_tables):
    """T = 8000: a block's rows do not fit in shared memory, so the launch
    writes the emissions to the output rows; byte for byte with the plain
    version, and a launch asked to keep them in shared memory raises."""
    host, tables = rans_tables
    T, lanes = 8000, 70
    assert tdr.encode_launch_config(T, host.num_distributions, tables.eo.device)[1] is False
    values, rows = _rans_payload(host, T, lanes, "some", seed=T)
    enc = tdr.encode_lanes_cuda(values, rows, tables)
    _assert_same(enc, tdr.encode_lanes_reference(values, rows, tables))
    with pytest.raises(ValueError, match="shared memory"):
        tdr._encode_launch(values, rows, tables, (32, True))
    buf, lengths, dest, raw, _ = enc
    len_h = lengths.cpu().numpy()
    words = torch.from_numpy(
        tdr.assemble_streams(buf.cpu().numpy().view(np.uint16), len_h).view(np.int16)).cuda()
    off = torch.from_numpy(tdr.lane_offsets(len_h)).cuda()
    vals, _, ptr = tdr.decode_lanes_cuda(words, off, rows, tables)
    assert torch.equal(tdr.fix_escapes(vals, dest, raw), values)
    assert torch.equal(ptr, lengths)


@pytest.mark.parametrize("shift", range(8))
def test_rans_decode_words_at_any_address(rans_tables, shift):
    """Words that are a slice of a larger buffer, starting ``shift`` words
    past a 16-byte boundary, decode as the plain version decodes them, and
    so do the same words cut short; nothing outside the slice is read
    (the buffer around it holds other words)."""
    host, tables = rans_tables
    values, rows = _rans_payload(host, 37, 65, "some", seed=shift)
    buf, lengths, dest, raw, _ = tdr.encode_lanes_cuda(values, rows, tables)
    len_h = lengths.cpu().numpy()
    flat = torch.from_numpy(
        tdr.assemble_streams(buf.cpu().numpy().view(np.uint16), len_h).view(np.int16)).cuda()
    off = torch.from_numpy(tdr.lane_offsets(len_h)).cuda()
    big = torch.full((flat.numel() + 16,), -1, dtype=torch.int16, device="cuda")
    words = big[shift:shift + flat.numel()]
    words.copy_(flat)
    assert words.data_ptr() % 16 == 2 * shift
    got = tdr.decode_lanes_cuda(words, off, rows, tables)
    _assert_same(got, tdr.decode_lanes_reference(words, off, rows, tables))
    assert torch.equal(tdr.fix_escapes(got[0], dest, raw), values)
    short = words[: flat.numel() - 5]
    _assert_same(tdr.decode_lanes_cuda(short, off, rows, tables),
                 tdr.decode_lanes_reference(short, off, rows, tables))


# the launch configurations, from the kernels' own shared-memory layout
# (the C entries) and the card's limit
@pytest.mark.parametrize("T", [1, 24, 320, 3000, 8000])
def test_encode_launch_config_fits_shared_memory(T):
    """The emissions stay in shared memory while a block's rows fit, and
    go straight to the output rows past that; never more than fits."""
    _needs_card()
    dev = torch.device("cuda", torch.cuda.current_device())
    smem_bytes, limit = tdr._kernel_fns()[3], tdr._smem_limit(dev)
    threads, smem = tdr.encode_launch_config(T, 64, dev)
    assert smem == (T <= 3000)
    assert smem == (smem_bytes(T, 64, threads, 1) <= limit)
    assert smem_bytes(T, 64, threads, int(smem)) <= limit


def test_decode_launch_config_fits_shared_memory(real_tables):
    """The Gaussian compact tables are staged in shared memory, and each
    launch's blocks fit beside them; no more blocks than SMs while a block
    can grow."""
    _, tables = real_tables["gaussian"]
    dev = tables.ctab.device
    smem_bytes, limit = tdr._kernel_fns()[2], tdr._smem_limit(dev)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    nbytes = 4 * tables.ctab.numel()
    for lanes in (1, 2048, 32768, 1 << 22):
        threads, smem = tdr.decode_launch_config(tables, lanes, dev)
        assert smem and smem_bytes(nbytes, threads, 1) <= limit
        assert (threads * sm_count >= lanes or smem_bytes(nbytes, 2 * threads, 1) > limit
                or threads == 1024)


# --- the scan wire's programs as CUDA graphs --------------------------------------
# narrow twins, weights from the seed: tests/test_torch_scan_wire.py's
# context and hyper widths, with the transforms as narrow as the window
# attention kernel takes (head width 16: cnn's N and M of 128 over 8
# heads, stf's embed 16 over heads 1/2/4/8); 4 slices with a prefix
# support of 2, so the chain freezes its support buffer
SCAN_TWINS = {
    "cnn": dict(N=128, M=128, num_slices=4, max_support_slices=2,
                hyper_enc_widths=(64, 56, 48, 40, 32), hyper_dec_widths=(40, 48, 56, 64, 64),
                cc_widths=(24, 20, 16, 12)),
    "stf": dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
                patch_size=2, num_slices=4, drop_path_rate=0.1,
                hyper_enc_widths=(64, 56, 48, 40, 32), hyper_dec_widths=(40, 48, 56, 64, 64),
                cc_widths=(24, 20, 16, 12)),
}
# the port's kernels by the names of their CUDA functions in a trace
TRACE_NAMES = {"window_attention": "window_attention_kernel", "gdn_forward": "gdn_fwd_kernel",
               "DECODE_LAUNCHES": "rans_decode_lanes_kernel",
               "ENCODE_LAUNCHES": "rans_encode_lanes_kernel"}


def _scan_codecs(name, seed=0):
    """-> (model, graphed scan-wire codec, the same launch by launch);
    ``name``: a SCAN_TWINS model or a FAMILY_TWINS twin."""
    from icm_tpu_torch.models import DeviceWireCodec

    model = _family_model(name, seed) if name in FAMILY_TWINS else _scan_model(name, seed)
    return (model, DeviceWireCodec(model, lanes_per_image=4, scan_wire=True),
            DeviceWireCodec(model, lanes_per_image=4, scan_wire=True, cuda_graphs=False))


def _scan_model(name, seed=0):
    from icm_tpu_torch.models import create_model

    return create_model(name, device="cuda", seed=seed, **SCAN_TWINS[name])


def _scan_images(size=64, scale=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((2, size, size, 3)) if scale is None else scale * rng.standard_normal(
        (2, size, size, 3))
    return torch.from_numpy(x.astype(np.float32)).cuda()


def _same_codec_outputs(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name", ["cnn", "stf", "d8", "d16"])
def test_scan_wire_graphs_replay_as_launches(name):
    """The four programs (front, conditioning, the chain each way,
    assembly) replayed from their graphs give the bits of the same
    functions launch by launch, twice in a row; the round trip is
    bit-exact both ways."""
    _needs_card()
    _, graphed, plain = _scan_codecs(name)
    x = _scan_images()
    want = plain.compress(x, return_debug=True)
    want_dec = plain.decompress(want["strings"], want["shape"])
    assert torch.equal(want_dec["y_hat"], want["y_hat"])
    assert torch.equal(want_dec["x_hat"], want["x_hat"])
    assert len(plain.graphs) == 0
    for _ in range(2):
        _same_codec_outputs(graphed.compress(x, return_debug=True), want)
        _same_codec_outputs(graphed.decompress(want["strings"], want["shape"]), want_dec)
    programs = {key[0] + (f" {key[1]}" if key[0] == "scan" else "") for key in graphed.graphs.graphs()}
    assert programs == {"front", "state", "scan encode", "scan decode", "assemble"}
    for key, g in graphed.graphs.graphs().items():
        launched = g.fn(*g.static_in)
        for _ in range(2):
            replayed = g(g.static_in)
            assert all(torch.equal(a, b) for a, b in zip(replayed, launched)), key


@pytest.mark.parametrize("name", ["cnn", "stf", "d8", "d16"])
def test_scan_wire_recaptures_after_a_weight_change(name):
    """A weight changed in place: the graphed codec captures again and
    gives what the launch-by-launch codec gives on the changed weights
    (the family's: a padded first conv's and a refiner's)."""
    _needs_card()
    model, graphed, plain = _scan_codecs(name)
    x = _scan_images()
    before = graphed.compress(x, return_debug=True)
    with torch.no_grad():
        model.cc_mean_1.Conv_0.weight.mul_(1.5)
        (model.g_s[-1] if name == "cnn" else model.g_s.to_rgb).weight.mul_(0.5)
        if name in FAMILY_TWINS:
            model.mu_refine_1.stage0.block0.mlp.Dense_1.weight.mul_(2.0)
    after = graphed.compress(x, return_debug=True)
    _same_codec_outputs(after, plain.compress(x, return_debug=True))
    assert not torch.equal(after["y_hat"], before["y_hat"])
    assert not torch.equal(after["x_hat"], before["x_hat"])
    _same_codec_outputs(graphed.decompress(after["strings"], after["shape"]),
                        plain.decompress(after["strings"], after["shape"]))


def test_scan_wire_escape_ladder_on_the_card():
    """40 N(0, 1) at 128 px: a tier above 0, and the round trip through
    that tier's decode graph bit-exact and equal to launch by launch."""
    _needs_card()
    _, graphed, plain = _scan_codecs("cnn")
    x = _scan_images(128, scale=40.0, seed=7)
    enc = graphed.compress(x, return_debug=True)
    tiers = {blob[4] for blob in enc["strings"][0]}
    assert len(tiers) == 1 and tiers.pop() > 0
    dec = graphed.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    assert any(k[:2] == ("scan", "decode") and k[-1] > 0 for k in graphed.graphs.graphs())
    _same_codec_outputs(dec, plain.decompress(enc["strings"], enc["shape"]))


@pytest.mark.parametrize("name", ["cnn", "stf", "d8", "d16"])
def test_scan_wire_replay_counts_match_the_profiler(name):
    """The launches each graph adds to the counters at a replay are the
    port's kernels the profiler sees in that replay."""
    _needs_card()
    from torch.profiler import ProfilerActivity, profile

    _, graphed, _ = _scan_codecs(name)
    x = _scan_images()
    enc = graphed.compress(x, return_debug=True)
    graphed.decompress(enc["strings"], enc["shape"])
    for key, g in graphed.graphs.graphs().items():
        counted = +Counter({k: sum(c.values()) for k, c in g.launches.items()})
        traces = []
        # the trace can drop a kernel record (seen once on the card): up to
        # three traced replays, none with a kernel more than counted
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                g(g.static_in)
                torch.cuda.synchronize()
            traced = Counter()
            for e in prof.events():
                for counter, kernel in TRACE_NAMES.items():
                    if e.device_type.name == "CUDA" and kernel in e.name:
                        traced[counter] += 1
            assert not traced - counted, (key, counted, traced)
            traces.append(traced)
            if traced == counted:
                break
        assert traces[-1] == counted, (key, counted, traces)


# --- the zigzag family on the card -----------------------------------------------
# narrow twins with the transforms at head width 16 (embed 16 over heads
# 1/2/4/8, M = 128) and the refiners at the family's two head widths: 4
# heads over 32-channel slices (D 8, stf7's window 8) and over 64-channel
# zigzag blocks (D 16, stf8's unconstrained order and tail-clamped mean
# window, at window 4)
FAMILY_TWINS = {
    "d8": ("stf7", dict(num_slices=4, spatial_number=1, support_mode="sliding", max_support=2,
                        mean_mode="full", mu_refine=(2,), scale_refine=(1,), lrp_refine=(2,),
                        refine_window=8)),
    "d16": ("stf8", dict(num_slices=2, spatial_number=2, support_mode="sliding", max_support=4,
                         mean_mode="window", mean_window=8, mu_refine=(2,), scale_refine=(1,),
                         lrp_refine=(1,), refine_window=4, zigzag_constrained=False)),
}
FAMILY_WIDTHS = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4,
                     patch_size=2, drop_path_rate=0.1, hyper_enc_widths=(64, 56, 48, 40, 32),
                     hyper_dec_widths=(40, 48, 56, 64, 128), cc_widths=(24, 20, 16, 12))


@pytest.mark.parametrize("twin", sorted(FAMILY_TWINS))
def test_family_twin_wires_and_forward_on_the_card(twin):
    """Host wire and device wire round trips bit-exact on 2 x 128 px, the
    device wire's y_hat the host wire's, one window-attention launch a
    Swin block (refiners included) and none of GDN's, one decode launch a
    slice and one for z; the eval forward against the CPU's within 1e-3."""
    _needs_card()
    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec, create_model
    from icm_tpu_torch.nn.swin import SwinBlock

    preset, ctx = FAMILY_TWINS[twin]
    model = create_model(preset, device="cuda", seed=0, **FAMILY_WIDTHS, **ctx)
    blocks = {part: sum(isinstance(m, SwinBlock) for m in getattr(model, part).modules())
              for part in ("g_a", "g_s")}
    refiners = sum(isinstance(m, SwinBlock) for n, m in model.named_modules() if "_refine_" in n)
    assert refiners > 0
    x = _scan_images(128)
    host = CharmCodec(model)
    before = twa.LAUNCHES.copy()
    enc = host.compress(x, return_debug=True)
    torch.cuda.synchronize()
    assert by_dtype(twa.LAUNCHES - before) == Counter(
        {torch.float32: blocks["g_a"] + blocks["g_s"] + refiners})
    before = twa.LAUNCHES.copy()
    fwd = tgdn.FWD_LAUNCHES.copy()
    dec = host.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    assert by_dtype(twa.LAUNCHES - before) == Counter({torch.float32: blocks["g_s"] + refiners})
    assert tgdn.FWD_LAUNCHES == fwd
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])

    dev = DeviceWireCodec(model, lanes_per_image=4)
    denc = dev.compress(x, return_debug=True)
    decodes = tdr.DECODE_LAUNCHES
    ddec = dev.decompress(denc["strings"], denc["shape"])
    torch.cuda.synchronize()
    assert tdr.DECODE_LAUNCHES - decodes == model.ctx_slices + 1
    assert torch.equal(denc["y_hat"], enc["y_hat"])
    assert torch.equal(ddec["y_hat"], denc["y_hat"]) and torch.equal(ddec["x_hat"], denc["x_hat"])

    cpu = create_model(preset, device="cpu", seed=0, **FAMILY_WIDTHS, **ctx)
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, ref = model(x), cpu(x.cpu())
    for a, b in ((got["x_hat"], ref["x_hat"]), (got["likelihoods"]["y"], ref["likelihoods"]["y"])):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3)


def _family_model(twin, seed=0, device="cuda", **overrides):
    from icm_tpu_torch.models import create_model

    preset, ctx = FAMILY_TWINS[twin]
    return create_model(preset, device=device, seed=seed, **{**FAMILY_WIDTHS, **ctx, **overrides})


@pytest.mark.parametrize("twin", sorted(FAMILY_TWINS))
def test_family_scan_wire_on_the_card(twin):
    """The family twins' scan wire on 2 x 64 px: the round trip bit-exact,
    one window-attention launch a Swin block (compress with its debug
    reconstruction: g_a, g_s and the refiners; decompress g_s and the
    refiners) and one decode launch a slice inside the decode graph, plus
    z's outside; y_hat within JAX's bar of the device wire's."""
    _needs_card()
    from icm_tpu_torch.models import DeviceWireCodec
    from icm_tpu_torch.nn.swin import SwinBlock

    model, graphed, _ = _scan_codecs(twin)
    blocks = {part: sum(isinstance(m, SwinBlock) for m in getattr(model, part).modules())
              for part in ("g_a", "g_s")}
    refiners = sum(isinstance(m, SwinBlock) for n, m in model.named_modules() if "_refine_" in n)
    x = _scan_images()
    first = graphed.compress(x, return_debug=True)  # captures every program
    graphed.decompress(first["strings"], first["shape"])
    before, decodes = twa.LAUNCHES.copy(), tdr.DECODE_LAUNCHES
    enc = graphed.compress(x, return_debug=True)
    torch.cuda.synchronize()
    assert by_dtype(twa.LAUNCHES - before) == Counter(
        {torch.float32: blocks["g_a"] + blocks["g_s"] + refiners})
    before = twa.LAUNCHES.copy()
    dec = graphed.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    assert by_dtype(twa.LAUNCHES - before) == Counter({torch.float32: blocks["g_s"] + refiners})
    assert tdr.DECODE_LAUNCHES - decodes == model.ctx_slices + 1
    decode_graph = [g for k, g in graphed.graphs.graphs().items() if k[:2] == ("scan", "decode")]
    assert [sum(g.launches["DECODE_LAUNCHES"].values()) for g in decode_graph] == [
        model.ctx_slices]
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    denc = DeviceWireCodec(model, lanes_per_image=4).compress(x, return_debug=True)
    d = (enc["y_hat"] - denc["y_hat"]).abs()
    assert float((d > 1e-2).float().mean()) < 0.005 and float(d.median()) < 1e-4


@pytest.mark.parametrize("twin", sorted(FAMILY_TWINS))
def test_family_scan_charm_train_step_card_vs_cpu(twin):
    """One ``scan_charm=True`` training step at stochastic depth 0 on the
    card and on the CPU, the same weights and noise (one seeded CPU
    generator each): loss terms and every gradient within 1e-3 of its max
    (``chip_smoke.py``'s rule), one window-attention launch a Swin block;
    then at depth 0.5 the card's step is finite and repeats with one
    generator seed."""
    _needs_card()
    from icm_tpu_torch.models import cuda_numerics
    from icm_tpu_torch.nn.swin import SwinBlock
    from icm_tpu_torch.train import RateDistortionLoss

    cuda_numerics()

    model = _family_model(twin, drop_path_rate=0.0, scan_charm=True).train()
    cpu = _family_model(twin, device="cpu", drop_path_rate=0.0, scan_charm=True).train()
    cpu.load_state_dict(model.state_dict())
    x = _scan_images(64)
    criterion = RateDistortionLoss(0.01)

    def step(m, xs, seed=0):
        m.zero_grad(set_to_none=True)
        before = twa.LAUNCHES.copy()
        out = m(xs, generator=torch.Generator().manual_seed(seed))
        rd = criterion(out, xs)
        aux = m.aux_loss()
        (rd["loss"] + aux).backward()
        launched = by_dtype(twa.LAUNCHES - before)
        return ({k: float(v) for k, v in {**rd, "aux_loss": aux}.items()},
                {n: p.grad.detach().cpu() for n, p in m.named_parameters()}, launched)

    got_terms, got, launched = step(model, x)
    ref_terms, ref, _ = step(cpu, x.cpu())
    blocks = sum(isinstance(m, SwinBlock) for m in model.modules())
    assert launched == Counter({torch.float32: blocks})
    for k, v in ref_terms.items():
        assert abs(got_terms[k] - v) <= 1e-3 * max(abs(v), 1e-30), k
    for n in ref:
        err = (got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)
        assert err <= 1e-3, (n, float(err))
    sd = _family_model(twin, drop_path_rate=0.5, scan_charm=True).train()
    sd.load_state_dict(model.state_dict())
    a, ga, _ = step(sd, x, seed=1)
    b, _, _ = step(sd, x, seed=1)
    assert all(np.isfinite(v) for v in a.values()) and a == b
    assert all(bool(torch.isfinite(g).all()) for g in ga.values())


@pytest.mark.parametrize("twin", sorted(FAMILY_TWINS))
def test_family_bf16_wires_on_the_card(twin):
    """Under the bfloat16 policy, host and device wire on 2 x 128 px:
    bit-exact round trips, the device wire's y_hat the host wire's, every
    window-attention launch the bfloat16 build's (one a Swin block), bpp
    within 5% and mean |x_hat difference| under 0.01 of float32; the scan
    wire refuses the policy."""
    _needs_card()
    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec
    from icm_tpu_torch.nn import set_activation_dtype
    from icm_tpu_torch.nn.swin import SwinBlock

    model = _family_model(twin)
    blocks = sum(isinstance(m, SwinBlock) for n, m in model.named_modules()
                 if n.startswith("g_s") or "_refine_" in n)
    x = _scan_images(128)
    f32 = CharmCodec(model).compress(x, return_debug=True)
    set_activation_dtype(torch.bfloat16)
    try:
        with pytest.raises(ValueError, match="float32 only"):
            DeviceWireCodec(model, lanes_per_image=4, scan_wire=True)
        host, dev = CharmCodec(model), DeviceWireCodec(model, lanes_per_image=4)
        enc = host.compress(x, return_debug=True)
        before = twa.LAUNCHES.copy()
        dec = host.decompress(enc["strings"], enc["shape"])
        torch.cuda.synchronize()
        assert by_dtype(twa.LAUNCHES - before) == Counter({torch.bfloat16: blocks})
        denc = dev.compress(x, return_debug=True)
        ddec = dev.decompress(denc["strings"], denc["shape"])
    finally:
        set_activation_dtype(None)
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    assert torch.equal(ddec["y_hat"], denc["y_hat"]) and torch.equal(ddec["x_hat"], denc["x_hat"])
    assert torch.equal(denc["y_hat"], enc["y_hat"])

    def bpp(e):
        return 8 * sum(len(s) for k in (0, 1) for s in e["strings"][k]) / (2 * 128 * 128)

    assert bpp(enc) == pytest.approx(bpp(f32), rel=0.05)
    assert float((dec["x_hat"].float() - f32["x_hat"]).abs().mean()) < 0.01


# --- the CRC family on the card -----------------------------------------------------
# a narrow stf9 / stf12 / stf14 whose window attention runs built widths: N 64
# and mid 64 at 8 heads (D 8), M 128 (D 16), stf12's decoder head 2M = 256
# (D 32); 2 x 2x2 zigzag = 8 slices
CRC_WIDTHS = dict(N=64, M=128, mid=64, num_slices=2, max_support=4, support_num=8,
                  hyper_enc_widths=(128, 96, 64, 48, 32), hyper_dec_widths=(48, 64, 96, 128, 128),
                  cc_widths=(48, 32))
# the hyper-decoders' first convolutions read z_hat, which at the bottlenecks'
# init medians (0) is 0 wherever z rounds to 0: at these widths everywhere
Z_READERS = ("h_mean_s.Conv_0.weight", "h_scale_s.Conv_0.weight")


def _crc_model(name, device):
    """A narrow CRC model from seed 0 whose every layer codes nonzero
    symbols and reaches its weights' gradients: its biases drawn at 0.01
    (seed 0; the seeded init's are 0, and so mu and LRP of a latent that
    rounds to 0), stf13's segmentation analysis's last convolution scaled
    by 16 (``chip_smoke.CRC_GAIN``: at an untrained draw its latent
    rounds to 0 everywhere)."""
    from icm_tpu_torch.models import create_model

    model = create_model(name, device=device, seed=0, **CRC_WIDTHS)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.copy_(0.01 * torch.randn(p.shape, generator=g))
        if name == "stf13":
            model.seg_g_a2.Conv_1.weight.mul_(16.0)
    return model


@pytest.mark.parametrize("name", ["stf9", "stf12", "stf14"])
def test_crc_wires_on_the_card(name):
    """Host, device and scan wire (graphed and launch by launch) on 2 x 128
    px: every round trip bit-exact; the device wire's y_hat and x_hat the
    host wire's, 4 encode launches and slices + 3 decode launches, the
    same on the scan wire with the slices' decodes inside its decode
    graph; the graphed scan wire's blobs and bits those of its launches;
    the eval forward against the CPU's within 1e-3."""
    _needs_card()
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.models.crc_codec import CRCCodec

    model = create_model(name, device="cuda", seed=0, **CRC_WIDTHS)
    x = _scan_images(128)
    host = CRCCodec(model, narrow=0.2)
    enc = host.compress(x, return_debug=True)
    dec = host.decompress(enc["strings"], enc["shape"], enc["human_shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    n = model.coder.ctx_slices
    outs = {}
    for wire, kw in (("device", {}), ("scan", dict(scan_wire=True)),
                     ("scan_launches", dict(scan_wire=True, cuda_graphs=False))):
        codec = CRCCodec(model, narrow=0.2, wire="device", **kw)
        w = codec.compress(x)  # the scan wire's graphs are captured by a first call
        codec.decompress(w["strings"], w["shape"], w["human_shape"])
        counts = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
        e = codec.compress(x, return_debug=True)
        d = codec.decompress(e["strings"], e["shape"], e["human_shape"])
        torch.cuda.synchronize()
        assert (tdr.ENCODE_LAUNCHES - counts[0], tdr.DECODE_LAUNCHES - counts[1]) == (4, n + 3)
        assert torch.equal(d["y_hat"], e["y_hat"]) and torch.equal(d["x_hat"], e["x_hat"])
        outs[wire] = (e, d)
        if wire == "scan":
            chain = [g for key, g in codec.graphs.graphs().items() if key[:2] == ("scan", "decode")]
            assert len(chain) == 1 and sum(chain[0].launches["DECODE_LAUNCHES"].values()) == n
    assert torch.equal(outs["device"][0]["y_hat"], enc["y_hat"])
    assert torch.equal(outs["device"][0]["x_hat"], enc["x_hat"])
    (se, sd), (pe, pd) = outs["scan"], outs["scan_launches"]
    assert se["strings"] == pe["strings"]
    for got, want in ((se, pe), (sd, pd)):
        assert torch.equal(got["y_hat"], want["y_hat"]) and torch.equal(got["x_hat"], want["x_hat"])
    diff = (se["y_hat"] - enc["y_hat"]).abs()
    assert float((diff > 1e-2).float().mean()) < 0.005 and float(diff.median()) < 1e-4

    cpu = create_model(name, device="cpu", seed=0, **CRC_WIDTHS)
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, ref = model(x), cpu(x.cpu())
    for key in ("x_hat", "machine_x_hat"):
        torch.testing.assert_close(got[key].cpu(), ref[key], rtol=0, atol=1e-3)
    for group in ("likelihoods", "machine_likelihoods"):
        torch.testing.assert_close(got[group]["y"].cpu(), ref[group]["y"], rtol=0, atol=1e-3)


# stf13's three layers' rates and the decoders no loss term reads
@pytest.mark.parametrize("name", ["stf9", "stf12", "stf13", "stf14"])
def test_crc_train_step_card_vs_cpu(name):
    """One training step (the port's one forward, which computes both of
    JAX's: the unrolled and ``scan_charm=True``) on the card and on the
    CPU, the same weights and noise (one seeded CPU generator each), every
    layer's rates: loss terms
    and every gradient within 1e-3 of its max (``chip_smoke.py``'s rule);
    the split decoder (stf13: g_s and seg_g_s) gets no gradient on
    either, and every other gradient but the z readers' (``Z_READERS``)
    has a nonzero entry (``_crc_model``'s weights)."""
    _needs_card()
    from icm_tpu_torch.models import cuda_numerics
    from icm_tpu_torch.train import RateDistortionLoss

    cuda_numerics()
    model = _crc_model(name, "cuda").train()
    cpu = _crc_model(name, "cpu").train()
    cpu.load_state_dict(model.state_dict())
    x = _scan_images(64)
    keys, fixed = model.likelihood_keys, model.no_loss
    criterion = RateDistortionLoss(0.01, likelihood_keys=keys)

    def step(m, xs):
        m.zero_grad(set_to_none=True)
        out = m(xs, generator=torch.Generator().manual_seed(0))
        rd = criterion(out, xs)
        aux = m.aux_loss()
        (rd["loss"] + aux).backward()
        return ({k: float(v) for k, v in {**rd, "aux_loss": aux}.items()},
                {n: p.grad.detach().cpu() for n, p in m.named_parameters() if p.grad is not None})

    got_terms, got = step(model, x)
    ref_terms, ref = step(cpu, x.cpu())
    assert set(got) == set(ref) == {n for n, _ in model.named_parameters()
                                    if not n.startswith(fixed)}
    zero = sorted(n for n, g in ref.items() if not bool(g.ne(0).any()))
    assert all(n.endswith(Z_READERS) for n in zero), zero
    for k, v in ref_terms.items():
        assert abs(got_terms[k] - v) <= 1e-3 * max(abs(v), 1e-30), k
    for n in ref:
        err = (got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)
        assert err <= 1e-3, (n, float(err))


def test_crc3_wires_on_the_card():
    """A narrow stf13 (both coders with LRP) on 2 x 128 px: host, device and
    scan wire (graphed and launch by launch), every round trip bit-exact
    in y_hat, seg_y_hat and x_hat; the device wire's the host wire's, 6
    encode launches and 2 x slices + 4 decode launches; the same on the
    scan wire, each layer's chain a decode graph of its own with one
    decode launch a slice (the LRP step inside it) and its encode graph
    none; the graphed scan wire's blobs and bits those of its launches;
    the eval forward against the CPU's within 1e-3. Both zigzag layers
    code nonzero symbols (``_crc_model``'s weights), so that no check
    compares a latent made of its context alone."""
    _needs_card()
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.models.crc_codec import CRC3Codec

    model = _crc_model("stf13", "cuda")
    x = _scan_images(128)
    keys = ("y_hat", "seg_y_hat", "x_hat")

    def dec(codec, e):
        return codec.decompress(e["strings"], e["shape"], e["seg_shape"], e["human_shape"])

    host = CRC3Codec(model, narrow=0.2)
    for k, syms in host.symbols(x).items():
        assert sum(int(s.count_nonzero()) for s in syms) > 0, k
    enc = host.compress(x, return_debug=True)
    assert len(enc["strings"]) == 6
    d = dec(host, enc)
    assert all(torch.equal(d[k], enc[k]) for k in keys)
    n = model.coder.ctx_slices
    outs = {}
    for wire, kw in (("device", {}), ("scan", dict(scan_wire=True)),
                     ("scan_launches", dict(scan_wire=True, cuda_graphs=False))):
        codec = CRC3Codec(model, narrow=0.2, wire="device", **kw)
        dec(codec, codec.compress(x))  # the scan wire's graphs are captured by a first call
        counts = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
        e = codec.compress(x, return_debug=True)
        d = dec(codec, e)
        torch.cuda.synchronize()
        assert (tdr.ENCODE_LAUNCHES - counts[0], tdr.DECODE_LAUNCHES - counts[1]) == (6, 2 * n + 4)
        assert all(torch.equal(d[k], e[k]) for k in keys)
        outs[wire] = (e, d)
        if wire == "scan":
            chains = {key: g for key, g in codec.graphs.graphs().items() if key[0] == "scan"}
            assert {(k[1], k[-1]) for k in chains} == {(w, layer) for w in ("encode", "decode")
                                                       for layer in ("m", "s")}
            for key, g in chains.items():
                want = n if key[1] == "decode" else 0
                assert sum(g.launches["DECODE_LAUNCHES"].values()) == want, key
                assert sum(g.launches["ENCODE_LAUNCHES"].values()) == 0, key
    assert all(torch.equal(outs["device"][0][k], enc[k]) for k in keys)
    (se, sd), (pe, pd) = outs["scan"], outs["scan_launches"]
    assert se["strings"] == pe["strings"]
    for got, want in ((se, pe), (sd, pd)):
        assert all(torch.equal(got[k], want[k]) for k in keys)
    for k in ("y_hat", "seg_y_hat"):
        diff = (se[k] - enc[k]).abs()
        assert float((diff > 1e-2).float().mean()) < 0.005 and float(diff.median()) < 1e-4, k

    cpu = create_model("stf13", device="cpu", seed=0, **CRC_WIDTHS)
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, ref = model(x), cpu(x.cpu())
    for key in ("x_hat", "machine_x_hat", "seg_x_hat"):
        torch.testing.assert_close(got[key].cpu(), ref[key], rtol=0, atol=1e-3)
    for group in ("likelihoods", "machine_likelihoods", "seg_likelihoods"):
        torch.testing.assert_close(got[group]["y"].cpu(), ref[group]["y"], rtol=0, atol=1e-3)


def test_lrp_scan_step_graph_matches_launches():
    """The scan wire's LRP step alone: a narrow stf13's machine coder on its
    own ``ZigzagScanWire`` (narrow 1: plain rounding), its encode and
    decode chain programs captured as CUDA graphs and run launch by launch
    on the same inputs: the same blobs and y_hat stacks bit for bit, the
    decoder's the encoder's, one decode launch a slice inside the decode
    graph; y_hat within the scan wire's distribution bar of the layer's
    unrolled eval loop with LRP, which LRP moves by more than the bar."""
    _needs_card()
    from icm_tpu_torch.graphs import GraphCache
    from icm_tpu_torch.models import build_codec_tables, create_model
    from icm_tpu_torch.models.device_codec import DeviceWireKit
    from icm_tpu_torch.models.scan_codec import ZigzagScanWire

    model = create_model("stf13", device="cuda", seed=0, **CRC_WIDTHS)
    coder = model.coder
    assert coder.apply_lrp
    with torch.no_grad():
        tables = build_codec_tables(model)
        kit = DeviceWireKit(tables, device=torch.device("cuda"))
        st = torch.from_numpy(tables.scale_table).cuda()
        y = model.machine.g_a(_scan_images(128).permute(0, 3, 1, 2).contiguous())
        z = coder.h_a(y)
        z_off = coder.eb_medians().reshape(1, -1, 1, 1)
        state = coder.ctx_prepare(torch.round(z - z_off) + z_off)
        y_stack = torch.stack(coder.latent_slices(y))
        outs, caches = [], (GraphCache(enabled=True), GraphCache(enabled=False))
        for graphs in caches:
            wire = ZigzagScanWire(coder, kit, st, graphs, "m")
            means, scales = wire.conditioning(state)
            wire.encode(means, scales, y_stack)  # captures on the card
            blobs, y_hats = wire.encode(means, scales, y_stack)
            y_hats = y_hats.clone()
            wire.decode(blobs, means, scales)
            outs.append((blobs, y_hats, wire.decode(blobs, means, scales).clone()))
        unrolled, _ = coder.code(y)
        coder.apply_lrp = False
        try:
            without, _ = coder.code(y)
        finally:
            coder.apply_lrp = True
    (gb, gy, gd), (pb, py, pd) = outs
    assert gb == pb
    assert torch.equal(gy, py) and torch.equal(gd, pd) and torch.equal(gd, gy)
    chain = {k[1]: g for k, g in caches[0].graphs().items() if k[0] == "scan"}
    assert sum(chain["decode"].launches["DECODE_LAUNCHES"].values()) == coder.ctx_slices
    assert sum(chain["encode"].launches["ENCODE_LAUNCHES"].values()) == 0
    diff = (coder.ctx_assemble(list(gy)) - unrolled).abs()
    assert float((diff > 1e-2).float().mean()) < 0.005 and float(diff.median()) < 1e-4
    assert float((unrolled - without).abs().median()) > 1e-3


def test_crc_bf16_wires_on_the_card():
    """A narrow stf12 under the bfloat16 policy, host and device wire on 2 x
    128 px: bit-exact round trips, the device wire's y_hat and x_hat the
    host wire's, every window-attention and GDN launch a bfloat16 build's
    (the decoder's head width 32 among them), bpp within 5% and mean
    |x_hat difference| under 0.01 of float32; the eval forward on the card
    against the CPU's, both under the policy: mean |x_hat difference| under
    0.02 (``chip_smoke.BF16_EVAL_TOL``); the scan wire refuses the policy."""
    _needs_card()
    from icm_tpu_torch.models import create_model
    from icm_tpu_torch.models.crc_codec import CRCCodec
    from icm_tpu_torch.nn import set_activation_dtype

    model = create_model("stf12", device="cuda", seed=0, **CRC_WIDTHS)
    x = _scan_images(128)
    f32 = CRCCodec(model, narrow=0.2).compress(x, return_debug=True)
    cpu = create_model("stf12", device="cpu", seed=0, **CRC_WIDTHS)
    cpu.load_state_dict(model.state_dict())
    set_activation_dtype(torch.bfloat16)
    try:
        with pytest.raises(ValueError, match="float32"):
            CRCCodec(model, wire="device", scan_wire=True)
        enc = {}
        for wire in ("host", "device"):
            codec = CRCCodec(model, narrow=0.2, wire=wire)
            before = (twa.LAUNCHES.copy(), tgdn.FWD_LAUNCHES.copy())
            e = enc[wire] = codec.compress(x, return_debug=True)
            d = codec.decompress(e["strings"], e["shape"], e["human_shape"])
            torch.cuda.synchronize()
            attn, gdn = twa.LAUNCHES - before[0], tgdn.FWD_LAUNCHES - before[1]
            assert set(by_dtype(attn)) == set(by_dtype(gdn)) == {torch.bfloat16}
            assert attn[torch.bfloat16, 32] == 2  # the decoder head, both sides
            assert torch.equal(d["y_hat"], e["y_hat"]) and torch.equal(d["x_hat"], e["x_hat"])
        with torch.no_grad():
            got, ref = model(x[:1]), cpu(x[:1].cpu())
    finally:
        set_activation_dtype(None)
    assert torch.equal(enc["device"]["y_hat"], enc["host"]["y_hat"])
    assert torch.equal(enc["device"]["x_hat"], enc["host"]["x_hat"])

    def bpp(e):
        return 8 * sum(len(b) for s in e["strings"] for b in s) / (2 * 128 * 128)

    assert bpp(enc["host"]) == pytest.approx(bpp(f32), rel=0.05)
    assert float((enc["host"]["x_hat"].float() - f32["x_hat"]).abs().mean()) < 0.01
    assert float((got["x_hat"].float().cpu() - ref["x_hat"].float()).abs().mean()) < 0.02


# --- the masked family on the card ----------------------------------------------------
# tests/test_masked_codec.py's TINY: window attention at head width 8, tokens of
# D = 16 (64 of them on 32 x 32 px); the three narrow twins of
# tests/test_torch_masked_*.py
MASKED_TINY = dict(embed_dim=8, depths=(1, 1), num_heads=(1, 2), window_size=4, patch_size=2,
                   drop_path_rate=0.0, num_slices=4, mask_win_size=2,
                   hyper_enc_widths=(16, 14, 12, 10, 8), hyper_dec_widths=(10, 12, 14, 16, 16))
MASKED_TWINS = {"stf3": ("stf3", {}), "stf3_causal": ("stf3", {"causal": True}),
                "stf4": ("stf4", {"causal": True, "sliding": 8})}
# the codecs' latent scale: the narrow stf4's y rounds to 0 everywhere at 1
# (its seeded weights), and at 4 codes 410 of 2,048 symbols nonzero
MASKED_LATENT_SCALE = {"stf3": 1.0, "stf3_causal": 1.0, "stf4": 4.0}


def _masked_model(twin, device, **widths):
    """A masked twin from seed 0 with its biases drawn at 0.01 (seed 0), so
    that its hyper tokens and context are not zero where its latent rounds
    to 0."""
    from icm_tpu_torch.models import create_model

    name, kw = MASKED_TWINS[twin]
    model = create_model(name, device=device, seed=0, **{**kw, **widths})
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.copy_(0.01 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.mark.parametrize("twin", sorted(MASKED_TWINS))
def test_masked_context_rows_at_full_width_on_the_card(twin):
    """The decoder's invariant at the published width (tokens of D = 768,
    stf4's 27-token windows) on the card: the context pass's rows <= i are
    bit-identical after the buffer's rows >= i are zeroed (the decoder's
    buffer) or redrawn, at several i, for stf3 under both masks and stf4
    with its causal mask; the rows after i do change."""
    _needs_card()
    from icm_tpu_torch.models import create_model, cuda_numerics

    cuda_numerics()
    name, kw = MASKED_TWINS[twin]
    kw = {k: v for k, v in kw.items() if k != "sliding"}
    model = create_model(name, device="cuda", seed=0, **kw).eval()
    g = torch.Generator().manual_seed(1)
    B, N, D = 2, 128, 768
    m_tok, s_tok = (0.5 * torch.randn(B, N, D, generator=g) for _ in range(2))
    y_tok = torch.randint(-2, 3, (B, N, D), generator=g).float()
    m_tok, s_tok, y_tok = m_tok.cuda(), s_tok.cuda(), y_tok.cuda()
    with torch.no_grad():
        base = model.causal_mu_scale(m_tok, s_tok, y_tok)
        for i in (0, 1, 31, 64, 127):
            for fill in ("zeros", "redrawn"):
                buf = y_tok.clone()
                buf[:, i:] = 0 if fill == "zeros" else torch.randint(
                    -2, 3, (B, N - i, D), generator=g).float().cuda()
                got = model.causal_mu_scale(m_tok, s_tok, buf)
                for a, b in zip(got, base):
                    assert torch.equal(a[:, :i + 1], b[:, :i + 1]), (i, fill)
                    if i + 1 < N:
                        assert not torch.equal(a[:, i + 1:], b[:, i + 1:]), (i, fill)


@pytest.mark.parametrize("twin", sorted(MASKED_TWINS))
def test_masked_twin_wires_on_the_card(twin):
    """A narrow twin on 2 x 32 px, host and device wire: round trips bit for
    bit, the device wire's y_hat and x_hat the host wire's, 2 encode and
    N + 1 decode launches (N = 64 tokens) on the device wire, some symbols
    nonzero (at ``MASKED_LATENT_SCALE``)."""
    _needs_card()
    from icm_tpu_torch.models.masked_codec import Stf3Codec

    model = _masked_model(twin, "cuda", **MASKED_TINY)
    x = _scan_images(32)
    enc = {}
    for wire in ("host", "device"):
        codec = Stf3Codec(model, wire=wire, latent_scale=MASKED_LATENT_SCALE[twin])
        counts = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
        e = enc[wire] = codec.compress(x, return_debug=True)
        d = codec.decompress(e["strings"], e["shape"])
        torch.cuda.synchronize()
        launches = (tdr.ENCODE_LAUNCHES - counts[0], tdr.DECODE_LAUNCHES - counts[1])
        assert launches == ((2, 65) if wire == "device" else (0, 0)), wire
        assert torch.equal(d["y_hat"], e["y_hat"]) and torch.equal(d["x_hat"], e["x_hat"])
        assert int(codec.symbols(x).count_nonzero()) > 0
    assert torch.equal(enc["device"]["y_hat"], enc["host"]["y_hat"])
    assert torch.equal(enc["device"]["x_hat"], enc["host"]["x_hat"])


@pytest.mark.parametrize("twin", sorted(MASKED_TWINS))
def test_masked_twin_forward_card_vs_cpu(twin):
    """A narrow twin's eval forward on the card against the plain CPU path
    on the same weights: x_hat and both likelihoods within 1e-3."""
    _needs_card()
    model = _masked_model(twin, "cuda", **MASKED_TINY)
    cpu = _masked_model(twin, "cpu", **MASKED_TINY)
    cpu.load_state_dict(model.state_dict())
    x = _scan_images(64)
    with torch.no_grad():
        got, ref = model(x), cpu(x.cpu())
    torch.testing.assert_close(got["x_hat"].cpu(), ref["x_hat"], rtol=0, atol=1e-3)
    for k in "yz":
        torch.testing.assert_close(got["likelihoods"][k].cpu(), ref["likelihoods"][k], rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("twin", ["stf3", "stf4"])
def test_masked_context_rows_at_full_width_on_the_card_bf16(twin):
    """The decoder's invariant under the bfloat16 policy at the published
    width on the card (tokens of D = 768 in bfloat16, as the encoder forms
    them; stf4's 27-token windows through its bfloat16 conv heads): the
    context pass's rows <= i bit-identical after the buffer's rows >= i are
    zeroed or set to 1; the rows after i do change."""
    _needs_card()
    from icm_tpu_torch.models import create_model, cuda_numerics
    from icm_tpu_torch.nn import set_activation_dtype

    cuda_numerics()
    name, kw = MASKED_TWINS[twin]
    kw = {k: v for k, v in kw.items() if k != "sliding"}
    model = create_model(name, device="cuda", seed=0, **kw).eval()
    g = torch.Generator().manual_seed(2)
    B, N, D = 2, 128, 768
    m_tok, s_tok = ((0.5 * torch.randn(B, N, D, generator=g)).bfloat16().cuda() for _ in range(2))
    y_tok = torch.randint(-2, 3, (B, N, D), generator=g).bfloat16().cuda()
    set_activation_dtype(torch.bfloat16)
    try:
        with torch.no_grad():
            base = model.causal_mu_scale(m_tok, s_tok, y_tok)
            for i in (0, 1, 64, 127):
                for fill in (0.0, 1.0):
                    buf = y_tok.clone()
                    buf[:, i:] = fill
                    got = model.causal_mu_scale(m_tok, s_tok, buf)
                    for a, b in zip(got, base):
                        assert torch.equal(a[:, :i + 1], b[:, :i + 1]), (i, fill)
                        if i + 1 < N:
                            assert not torch.equal(a[:, i + 1:], b[:, i + 1:]), (i, fill)
    finally:
        set_activation_dtype(None)


# stf2's narrow twins (tests/test_torch_masked_stf2like*.py): MASKED_TINY's
# transforms, 2 slices, mask window 2 and 3 sliding tokens (32 tokens of D =
# 32 on 32 px), and mask window 3 with 4 sliding (the latent padded, 18
# tokens of D = 72)
STF2_TWINS = {"stf2": {"mask_win_size": 2, "num_sliding": 3},
              "stf2_padded": {"mask_win_size": 3, "num_sliding": 4}}
# the twins' codec: their seeded y rounds to 0 everywhere at narrow 1; the
# residuals scaled by 4 code 444 of 2,048 (410 of 2,592) symbols nonzero (on
# the CPU), and the decoder still rebuilds y_hat from the coded symbols
STF2_TWIN_NARROW = 4.0


def _stf2_model(twin, device):
    """A narrow stf2 twin from seed 0, its biases drawn at 0.01 (seed 0)."""
    from icm_tpu_torch.models import create_model

    model = create_model("stf2", device=device, seed=0,
                         **{**MASKED_TINY, "num_slices": 2, **STF2_TWINS[twin]})
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.copy_(0.01 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("twin", sorted(STF2_TWINS))
def test_stf2_twin_wires_on_the_card(twin, policy):
    """A narrow stf2 twin on 2 x 32 px (under the bfloat16 policy too) on
    the host wire and the device wire's token scan, graphed and launch by
    launch: every round trip bit for bit, the device runs' blobs equal and
    their y_hat and x_hat the host wire's, 2 encode and N + 1 decode launches
    on each device run (graphed: the N token decodes inside the decode
    graph, z's outside), none on the host wire, some symbols nonzero."""
    _needs_card()
    from icm_tpu_torch.models.masked_codec import Stf2Codec
    from icm_tpu_torch.nn import set_activation_dtype

    model = _stf2_model(twin, "cuda")
    x = _scan_images(32)
    enc = {}
    set_activation_dtype(getattr(torch, policy) if policy == "bfloat16" else None)
    try:
        for run, kw in (("host", {}), ("graphed", {"wire": "device"}),
                        ("launched", {"wire": "device", "cuda_graphs": False})):
            codec = Stf2Codec(model, narrow=STF2_TWIN_NARROW, **kw)
            N = int(codec.symbols(x).shape[1])
            if run == "graphed":  # capture, outside the counts
                first = codec.compress(x)
                codec.decompress(first["strings"], first["shape"], first["out_hw"],
                                 first["lattice"])
            counts = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
            e = enc[run] = codec.compress(x, return_debug=True)
            d = codec.decompress(e["strings"], e["shape"], e["out_hw"], e["lattice"])
            torch.cuda.synchronize()
            launches = (tdr.ENCODE_LAUNCHES - counts[0], tdr.DECODE_LAUNCHES - counts[1])
            assert launches == ((0, 0) if run == "host" else (2, N + 1)), run
            assert torch.equal(d["y_hat"], e["y_hat"]) and torch.equal(d["x_hat"], e["x_hat"])
            assert e["y_hat"].dtype == (torch.bfloat16 if policy == "bfloat16" else torch.float32)
            assert int(codec.symbols(x).count_nonzero()) > 0
            if run == "graphed":
                decode = [g for k, g in codec.graphs.graphs().items() if k[:2] == ("scan", "decode")]
                assert len(decode) == 1
                assert sum(decode[0].launches["DECODE_LAUNCHES"].values()) == N
    finally:
        set_activation_dtype(None)
    assert enc["graphed"]["strings"] == enc["launched"]["strings"]
    for run in ("graphed", "launched"):
        for k in ("y_hat", "x_hat"):
            assert torch.equal(enc[run][k], enc["host"][k]), (run, k)


@pytest.mark.parametrize("twin", sorted(STF2_TWINS))
def test_stf2_twin_forward_card_vs_cpu(twin):
    """A narrow stf2 twin's eval forward on the card against the plain CPU
    path on the same weights: x_hat and both likelihoods within 1e-3."""
    _needs_card()
    model = _stf2_model(twin, "cuda")
    cpu = _stf2_model(twin, "cpu")
    cpu.load_state_dict(model.state_dict())
    x = _scan_images(64)
    with torch.no_grad():
        got, ref = model(x), cpu(x.cpu())
    torch.testing.assert_close(got["x_hat"].cpu(), ref["x_hat"], rtol=0, atol=1e-3)
    for k in "yz":
        torch.testing.assert_close(got["likelihoods"][k].cpu(), ref["likelihoods"][k], rtol=0,
                                   atol=1e-3)


# czigzag's narrow twin (tests/test_torch_czigzag.py's CZ_TINY: 8 zigzag steps
# of 32 channels, support 3, windows of 3) on 2 x 64 px and a seeded up_x4
CZ_TINY = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), window_size=4,
               patch_size=2, drop_path_rate=0.0, num_slices=2, max_support=3, support_num=3,
               hyper_depths=(1, 1), cc_widths=(24, 16))
CZ_TWIN_NARROW = 4.0


def _czigzag_model(device):
    """The narrow czigzag twin from seed 0, its biases drawn at 0.01 (seed 0)."""
    from icm_tpu_torch.models import create_model

    model = create_model("czigzag", device=device, seed=0, **CZ_TINY)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias"):
                p.copy_(0.01 * torch.randn(p.shape, generator=g))
    return model.eval()


def _czigzag_attention(model, side: str) -> Counter:
    """Window-attention launches of a czigzag side by head width: one a
    block of the analysis (compress), both hyper-encoder stacks (compress),
    both hyper-decoders' and the synthesis (both sides)."""
    from icm_tpu_torch.nn import CrossWindowAttention

    parts = ["syn_layer", "hyper_dec_"] + (["layer", "hyper_enc"] if side == "compress" else [])
    out = Counter()
    for name, mod in model.named_modules():
        if isinstance(mod, CrossWindowAttention) and name.startswith(tuple(parts)):
            out[mod.dim // mod.num_heads] += 1
    return out


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_czigzag_twin_wires_on_the_card(policy):
    """The narrow czigzag twin on the host wire, the device wire and (in
    float32) the scan wire, graphed and launch by launch: every round trip
    bit for bit; the device runs' y_hat and x_hat the host wire's (the scan
    wire's within JAX's bar of them), its graphed blobs equal to launched;
    window attention launched once a block by head width and in the
    policy's build; 2 encode and 9 decode launches on each device run
    (graphed: the 8 slice decodes inside the decode graph), none on the
    host wire; some symbols nonzero; y_hat in the policy's dtype. Under
    bfloat16 the scan wire refuses."""
    _needs_card()
    from icm_tpu_torch.models.crc_codec import CzigzagCodec
    from icm_tpu_torch.nn import set_activation_dtype

    dt = torch.bfloat16 if policy == "bfloat16" else torch.float32
    model = _czigzag_model("cuda")
    x, up = _scan_images(64), _scan_images(64, seed=1)
    N = model.ctx_slices
    runs = {"host": {}, "device": {"wire": "device"},
            "graphed": {"wire": "device", "scan_wire": True},
            "launched": {"wire": "device", "scan_wire": True, "cuda_graphs": False}}
    if policy == "bfloat16":
        runs = {k: runs[k] for k in ("host", "device")}
    enc = {}
    set_activation_dtype(dt if policy == "bfloat16" else None)
    try:
        for run, kw in runs.items():
            codec = CzigzagCodec(model, narrow=CZ_TWIN_NARROW, **kw)
            if run == "graphed":  # capture, outside the counts
                first = codec.compress(x, up)
                codec.decompress(first["strings"], first["shape"], up)
            for side in ("compress", "decompress"):
                before = (twa.LAUNCHES.copy(), tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
                if side == "compress":
                    e = enc[run] = codec.compress(x, up, return_debug=True)
                else:
                    d = codec.decompress(e["strings"], e["shape"], up)
                torch.cuda.synchronize()
                attn = Counter({D: n for (dtype, D), n in (twa.LAUNCHES - before[0]).items()
                                if dtype == dt})
                assert attn == _czigzag_attention(model, side), (run, side)
                assert sum((twa.LAUNCHES - before[0]).values()) == sum(attn.values())
                rans = (tdr.ENCODE_LAUNCHES - before[1], tdr.DECODE_LAUNCHES - before[2])
                want = (0, 0) if run == "host" else ((2, 0) if side == "compress" else (0, N + 1))
                assert rans == want, (run, side)
            assert torch.equal(d["y_hat"], e["y_hat"]) and torch.equal(d["x_hat"], e["x_hat"])
            assert e["y_hat"].dtype == dt
            assert sum(int(s.count_nonzero()) for s in codec.symbols(x, up)["y_hat"]) > 0
            if run == "graphed":
                decode = [g for k, g in codec.graphs.graphs().items() if k[:2] == ("scan", "decode")]
                assert len(decode) == 1
                assert sum(decode[0].launches["DECODE_LAUNCHES"].values()) == N
        if policy == "bfloat16":
            with pytest.raises(ValueError, match="float32"):
                CzigzagCodec(model, wire="device", scan_wire=True)
    finally:
        set_activation_dtype(None)
    for k in ("y_hat", "x_hat"):
        assert torch.equal(enc["device"][k], enc["host"][k]), k
    if policy == "float32":
        assert enc["graphed"]["strings"] == enc["launched"]["strings"]
        for k in ("y_hat", "x_hat"):
            assert torch.equal(enc["graphed"][k], enc["launched"][k]), k
        diff = (enc["graphed"]["y_hat"] - enc["host"]["y_hat"]).abs()
        assert float((diff > 1e-2).float().mean()) < 0.005 and float(diff.median()) < 1e-4


def test_czigzag_twin_forward_and_step_card_vs_cpu():
    """The narrow czigzag twin on the card against the plain CPU path on the
    same weights: the eval forward's x_hat and likelihoods within 1e-3; one
    training step (``make_train_step`` on an (x, up_x4) batch, the same
    noise from one seeded CPU generator each, no optimizer step: learning
    rates 0): its loss terms and every gradient within 1e-3 of its max."""
    _needs_card()
    from icm_tpu_torch.models import cuda_numerics
    from icm_tpu_torch.train import (RateDistortionLoss, TrainState, make_optimizer,
                                     make_train_step)

    cuda_numerics()
    model = _czigzag_model("cuda")
    cpu = _czigzag_model("cpu")
    cpu.load_state_dict(model.state_dict())
    x, up = _scan_images(64), _scan_images(64, seed=1)
    with torch.no_grad():
        got, ref = model(x, up), cpu(x.cpu(), up.cpu())
    torch.testing.assert_close(got["x_hat"].cpu(), ref["x_hat"], rtol=0, atol=1e-3)
    for k in "yz":
        torch.testing.assert_close(got["likelihoods"][k].cpu(), ref["likelihoods"][k], rtol=0,
                                   atol=1e-3)

    def step(m, batch):
        state = TrainState(m, make_optimizer(m, 0.0, 0.0, 0.0))
        terms = make_train_step(m, RateDistortionLoss(0.01))(
            state, batch, torch.Generator().manual_seed(0))
        return ({k: float(v) for k, v in terms.items()},
                {n: p.grad.detach().cpu() for n, p in m.named_parameters()})

    got_terms, got = step(model, (x, up))
    ref_terms, ref = step(cpu, (x.cpu(), up.cpu()))
    for k, v in ref_terms.items():
        assert abs(got_terms[k] - v) <= 1e-3 * max(abs(v), 1e-30), k
    for n in ref:
        err = (got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)
        assert err <= 1e-3, (n, float(err))


# a narrow cnn2: the scan twins' cnn codec (head width 16) with the JAX
# package's test student (4 classes, a basic-block ResNet of one block a
# stage); its classification kernel x128, so that some 3% of its scores pass
# the detection threshold (read on the CPU)
CNN2_TWIN = dict(SCAN_TWINS["cnn"], num_classes=4, task_block="basic", task_layers=(1, 1, 1, 1))


def _kernel_launches() -> tuple:
    return (twa.LAUNCHES.copy(), tgdn.FWD_LAUNCHES.copy(), tdr.ENCODE_LAUNCHES,
            tdr.DECODE_LAUNCHES)


def _launched_since(before: tuple) -> tuple:
    now = _kernel_launches()
    return (now[0] - before[0], now[1] - before[1], now[2] - before[2], now[3] - before[3])


@pytest.mark.parametrize("wire", ["device", "scan"])
def test_cnn2_twin_detects_on_the_card(wire):
    """The narrow cnn2 twin's serving call (``decompress_detect``) on the
    device wire and on the graphed scan wire: the kernels it launches are
    those of the wire's decompress alone (the student launches none), its
    y_hat and x_hat the encoder's; the student's classification and
    regression on the card within 1e-4 of their max of the CPU twin's on
    the same x_hat, the anchors equal; the detections ``decode_batch``'s of
    the card's maps, some of them found."""
    _needs_card()
    from icm_tpu_torch.models import DeviceWireCodec, create_model, cuda_numerics
    from icm_tpu_torch.models import decompress_detect
    from icm_tpu_torch.tasks import decode_batch

    cuda_numerics()
    model = create_model("cnn2", device="cuda", seed=0, **CNN2_TWIN)
    with torch.no_grad():
        model.studentNet.classification.output.weight.mul_(128.0)
    cpu = create_model("cnn2", device="cpu", seed=0, **CNN2_TWIN)
    cpu.load_state_dict(model.state_dict())
    codec = DeviceWireCodec(model, lanes_per_image=4, scan_wire=wire == "scan")
    x = _scan_images(64)
    enc = codec.compress(x, return_debug=True)
    codec.decompress(enc["strings"], enc["shape"])  # the scan wire captures its graphs
    before = _kernel_launches()
    codec.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    plain = _launched_since(before)
    before = _kernel_launches()
    out = decompress_detect(codec, enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    assert _launched_since(before) == plain and plain[3] == model.ctx_slices + 1
    assert torch.equal(out["y_hat"], enc["y_hat"]) and torch.equal(out["x_hat"], enc["x_hat"])
    with torch.no_grad():
        _, _, cls, reg, anchors = cpu.studentNet(out["x_hat"].cpu())
    for got, ref in ((out["classification"], cls), (out["regression"], reg)):
        err = (got.cpu() - ref).abs().max() / ref.abs().max()
        assert err <= 1e-4, float(err)
    assert torch.equal(out["anchors"].cpu(), anchors)
    want = decode_batch(out["classification"], out["regression"], out["anchors"], (64, 64))
    for got, ref in zip(out["detections"], want):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    assert sum(len(d[0]) for d in out["detections"]) > 0


# a narrow oj_ICM / seg_oj_ICM: the CRC card twins' codec widths (window
# attention at D 8 and 16) with the task net at one block a stage
OJ_WIDTHS = dict(CRC_WIDTHS, task_layers=(1, 1, 1, 1))


def _oj_model(name, device):
    """A narrow oj model from seed 0 whose layers code nonzero symbols: its
    codec's biases drawn at 0.01 (seed 0), as ``_crc_model``'s, and
    seg_oj_ICM's segmentation analysis's last convolution scaled by 3 (as
    ``chip_smoke.OJ_GAIN``: unscaled, its latent rounds to 0 everywhere at
    narrow 0.2; x3 codes 797 of its 6,144 symbols nonzero, read on the
    CPU)."""
    from icm_tpu_torch.models import create_model

    model = create_model(name, device=device, seed=0, **OJ_WIDTHS)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".bias") and not n.startswith("task_net."):
                p.copy_(0.01 * torch.randn(p.shape, generator=g))
        if name == "seg_oj_ICM":
            model.seg_g_a.Conv_3.weight.mul_(3.0)
    return model


def _oj_eval_card_vs_cpu(name, model, x):
    """The eval forward on the card against the CPU's, the same weights:
    the reconstructions and each layer's y likelihoods within 1e-3, the
    teacher's and the student's P2-P6 within 1e-3 of their max."""
    cpu = _oj_model(name, "cpu")
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, ref = model(x), cpu(x.cpu())
    for key in ("x_hat", "machine_x_hat"):
        if key in ref:
            torch.testing.assert_close(got[key].cpu(), ref[key], rtol=0, atol=1e-3)
    for group in ("likelihoods", "machine_likelihoods"):
        if group in ref:
            torch.testing.assert_close(got[group]["y"].cpu(), ref[group]["y"], rtol=0, atol=1e-3)
    for group in ("Teacher_output_features", "Student_output_features"):
        for k, v in ref[group].items():
            err = (got[group][k].cpu() - v).abs().max() / v.abs().max()
            assert err <= 1e-3, (group, k, float(err))


def test_oj_wires_on_the_card():
    """A narrow oj_ICM on 2 x 128 px: the host wire (``CharmCodec``) and the
    device wire (``DeviceWireCodec``: 2 encode and slices + 1 decode
    launches) bit-exact, the device wire's y_hat and x_hat the host wire's;
    the scan wire refused; the eval forward against the CPU's."""
    _needs_card()
    from icm_tpu_torch.models import CharmCodec, DeviceWireCodec

    model = _oj_model("oj_ICM", "cuda")
    x = _scan_images(128)
    host = CharmCodec(model, narrow=0.2)
    enc = host.compress(x, return_debug=True)
    dec = host.decompress(enc["strings"], enc["shape"])
    assert torch.equal(dec["y_hat"], enc["y_hat"]) and torch.equal(dec["x_hat"], enc["x_hat"])
    assert sum(int(s.count_nonzero()) for s in host._encode_symbols(x)["syms"]) > 0
    dev = DeviceWireCodec(model, narrow=0.2)
    counts = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
    e = dev.compress(x, return_debug=True)
    d = dev.decompress(e["strings"], e["shape"])
    torch.cuda.synchronize()
    assert (tdr.ENCODE_LAUNCHES - counts[0], tdr.DECODE_LAUNCHES - counts[1]) == (
        2, model.ctx_slices + 1)
    for k in ("y_hat", "x_hat"):
        assert torch.equal(d[k], e[k]) and torch.equal(e[k], enc[k]), k
    with pytest.raises(NotImplementedError, match="FasterRCNN_Coding"):
        DeviceWireCodec(model, scan_wire=True)
    _oj_eval_card_vs_cpu("oj_ICM", model, x)


def test_seg_oj_wires_on_the_card():
    """A narrow seg_oj_ICM on 2 x 128 px: ``SegOjCodec`` on the host, device
    and scan wires (graphed and launch by launch), every round trip
    bit-exact in y_hat, seg_y_hat and x_hat, both layers coding nonzero
    symbols; the device wire's the host wire's, 4 encode and 2 x (slices +
    1) decode launches, the same on the scan wire with each layer's chain a
    graph each way, one decode launch a slice inside its decode graph; the
    graphed scan wire's blobs and bits those of its launches, its latents
    within the scan wire's bar of the device wire's; the eval forward
    against the CPU's."""
    _needs_card()
    from icm_tpu_torch.models.crc_codec import SegOjCodec

    model = _oj_model("seg_oj_ICM", "cuda")
    x = _scan_images(128)
    keys = ("y_hat", "seg_y_hat", "x_hat")

    def dec(codec, e):
        return codec.decompress(e["strings"], e["shape"], e["seg_shape"])

    host = SegOjCodec(model, narrow=0.2)
    for k, syms in host.symbols(x).items():
        assert sum(int(s.count_nonzero()) for s in syms) > 0, k
    enc = host.compress(x, return_debug=True)
    assert len(enc["strings"]) == 4
    d = dec(host, enc)
    assert all(torch.equal(d[k], enc[k]) for k in keys)
    n = model.coder.ctx_slices
    outs = {}
    for wire, kw in (("device", {}), ("scan", dict(scan_wire=True)),
                     ("scan_launches", dict(scan_wire=True, cuda_graphs=False))):
        codec = SegOjCodec(model, narrow=0.2, wire="device", **kw)
        dec(codec, codec.compress(x))  # the scan wire's graphs are captured by a first call
        counts = (tdr.ENCODE_LAUNCHES, tdr.DECODE_LAUNCHES)
        e = codec.compress(x, return_debug=True)
        d = dec(codec, e)
        torch.cuda.synchronize()
        assert (tdr.ENCODE_LAUNCHES - counts[0], tdr.DECODE_LAUNCHES - counts[1]) == (
            4, 2 * (n + 1))
        assert all(torch.equal(d[k], e[k]) for k in keys)
        outs[wire] = (e, d)
        if wire == "scan":
            chains = {key: g for key, g in codec.graphs.graphs().items() if key[0] == "scan"}
            assert {(k[1], k[-1]) for k in chains} == {(w, layer) for w in ("encode", "decode")
                                                       for layer in ("m", "s")}
            for key, g in chains.items():
                want = n if key[1] == "decode" else 0
                assert sum(g.launches["DECODE_LAUNCHES"].values()) == want, key
    assert all(torch.equal(outs["device"][0][k], enc[k]) for k in keys)
    (se, sd), (pe, pd) = outs["scan"], outs["scan_launches"]
    assert se["strings"] == pe["strings"]
    for got, want in ((se, pe), (sd, pd)):
        assert all(torch.equal(got[k], want[k]) for k in keys)
    for k in ("y_hat", "seg_y_hat"):
        diff = (se[k] - enc[k]).abs()
        assert float((diff > 1e-2).float().mean()) < 0.005 and float(diff.median()) < 1e-4, k
    _oj_eval_card_vs_cpu("seg_oj_ICM", model, x)


# the oj models' training patterns (tools/train_oj.py, train_seg_oj.py)
OJ_PATTERNS = {"oj_ICM": dict(freeze_patterns=("task_net",)),
               "seg_oj_ICM": dict(freeze_patterns=("task_net",), train_patterns=("seg",))}


@pytest.mark.parametrize("name", sorted(OJ_PATTERNS))
def test_oj_train_step_card_vs_cpu(name):
    """One step of ``DetectionICMLoss(1.0)`` on the card and on the CPU, the
    same weights and noise, the optimizer's patterns freezing what the
    training tools freeze: the same parameters take gradients on both
    (oj_ICM's codec; seg_oj_ICM's ``seg*`` alone), the loss terms (the
    feature term above 0) and every gradient within 1e-3 of its max."""
    _needs_card()
    from icm_tpu_torch.models import cuda_numerics
    from icm_tpu_torch.train import DetectionICMLoss, make_optimizer

    cuda_numerics()
    model = _oj_model(name, "cuda").train()
    cpu = _oj_model(name, "cpu").train()
    cpu.load_state_dict(model.state_dict())
    for m in (model, cpu):
        make_optimizer(m, **OJ_PATTERNS[name])
    x = _scan_images(64)
    criterion = DetectionICMLoss(1.0)

    def step(m, xs):
        m.zero_grad(set_to_none=True)
        out = m(xs, generator=torch.Generator().manual_seed(0))
        terms = criterion(out, xs)
        aux = m.aux_loss()
        (terms["loss"] + aux).backward()
        return ({k: float(v) for k, v in {**terms, "aux_loss": aux}.items()},
                {n: p.grad.detach().cpu() for n, p in m.named_parameters() if p.grad is not None})

    got_terms, got = step(model, x)
    ref_terms, ref = step(cpu, x.cpu())
    trained = {n for n, _ in model.named_parameters() if not n.startswith("task_net.")
               and (name == "oj_ICM" or n.startswith("seg_"))}
    assert set(got) == set(ref) == trained
    assert ref_terms["feature_loss"] > 0
    for k, v in ref_terms.items():
        assert abs(got_terms[k] - v) <= 1e-3 * max(abs(v), 1e-30), k
    for n in ref:
        err = (got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)
        assert err <= 1e-3, (n, float(err))


# (dim, heads): czigzag's head widths 16 (its transforms' 48 channels at 3
# heads), 48 and 96 (its hyper stacks' 192 and 384 channels at 4 heads)
CROSS_WIDTHS = [(48, 3), (192, 4), (384, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dim,heads", CROSS_WIDTHS)
def test_cross_window_attention_on_the_card(dim, heads, dtype):
    """czigzag's cross window attention (``CrossWindowAttention``: q from
    x's windows, k and v from the context's) on the card against the plain
    CPU path on the same weights, at window 4 with the shifted blocks'
    four classes on 2 x 16 x 16: one launch of the kernel's build of the
    policy's dtype and head width, the output within 1e-4 (f32: cuBLAS's
    projections sum in another order) or 2e-2 (bf16)."""
    _needs_card()
    from icm_tpu_torch.models import init_parameters
    from icm_tpu_torch.nn import CrossWindowAttention, set_activation_dtype
    from icm_tpu_torch.nn.layers import ShiftedWindows, window_partition

    cpu = CrossWindowAttention(dim, (4, 4), heads)
    init_parameters(cpu, torch.Generator().manual_seed(dim))
    card = CrossWindowAttention(dim, (4, 4), heads).cuda()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(dim)
    maps = [torch.from_numpy(rng.standard_normal((2, 16, 16, dim)).astype(np.float32))
            for _ in range(2)]
    xw, cw = (window_partition(m, 4).reshape(-1, 16, dim) for m in maps)
    geometry = ShiftedWindows(4, 2)
    dt = getattr(torch, dtype)
    set_activation_dtype(dt if dtype == "bfloat16" else None)
    try:
        with torch.no_grad():
            before = twa.LAUNCHES.copy()
            got = card(xw.cuda(), *geometry._classes(16, 16, 2, "cuda"), cw.cuda())
            torch.cuda.synchronize()
            assert twa.LAUNCHES - before == Counter({(dt, dim // heads): 1})
            ref = cpu(xw, *geometry._classes(16, 16, 2, "cpu"), cw)
    finally:
        set_activation_dtype(None)
    assert got.dtype == ref.dtype == dt
    torch.testing.assert_close(got.float().cpu(), ref.float(), rtol=0,
                               atol=1e-4 if dtype == "float32" else 2e-2)


# --- chip_smoke.py's profiler readings ---------------------------------------------------
def _chip_smoke():
    """chip_smoke.py loaded as a module (its helpers; its main is not run)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _exported(prof, mark, uncounted=()):
    """A profiler session's chrome-trace export from the event named
    ``mark`` on: (its card spans in microseconds: kernels, copies and
    memsets; its kernels counted by name; its ATen operator calls but
    those named in ``uncounted``)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    start = min(e["ts"] for e in events if e.get("name") == mark and "ts" in e)
    events = [e for e in events if e.get("ts", start - 1) >= start and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    aten = sum(1 for e in events if e.get("cat") == "cpu_op"
               and e["name"].startswith("aten::") and e["name"] not in uncounted)
    return spans, Counter(e["name"] for e in events if e.get("cat") == "kernel"), aten


@pytest.mark.parametrize("side", ["compress", "decompress"])
def test_profiler_events_read_what_the_trace_export_reads(side, monkeypatch):
    """chip_smoke.py reads a profiled call from the profiler's own events
    (``profiled_call``, ``traced_kernels``), without a chrome-trace export.
    On one side of a narrow stf4 twin's device wire, each reading against
    the export of its own session: the card's spans as many and their
    union's length (device busy ms) within the export's rounding (a few ns
    a span), the ATen calls and the kernels by name equal. The ATen calls
    against a CPU-only profile's summary of the same call
    (``key_averages``, chip_smoke.py's count before it read the events):
    never fewer, and at most 1% more, since the summary folds an operator
    into its parent where it is that parent's one child of the same name
    (``a & 1``: ``aten::bitwise_and`` twice)."""
    _needs_card()
    from torch.profiler import ProfilerActivity, profile

    from icm_tpu_torch.models.masked_codec import Stf3Codec

    smoke = _chip_smoke()
    sessions = []
    session = smoke.profile_session
    monkeypatch.setattr(smoke, "profile_session", lambda fn: sessions.append(session(fn))
                        or sessions[-1])
    codec = Stf3Codec(_masked_model("stf4", "cuda", **MASKED_TINY), wire="device",
                      latent_scale=MASKED_LATENT_SCALE["stf4"])
    x = _scan_images(32)
    fn = dict(zip(("compress", "decompress"),
                  smoke.codec_side_runs(codec, x, codec.compress(x))))[side]
    fn()

    aten, busy_ms = smoke.profiled_call(fn)
    spans, _, exported_aten = _exported(sessions[-1], smoke.TRACE_MARK, smoke.ATEN_UNCOUNTED)
    assert aten == exported_aten > 0
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    assert len(smoke.card_spans(smoke.marked_events(sessions[-1]))) == len(spans) > 0
    assert busy_ms == pytest.approx(busy_us / 1e3, rel=0, abs=4e-6 * len(spans) + 1e-6)

    names = smoke.traced_kernels(fn)
    assert names == dict(_exported(sessions[-1], smoke.TRACE_MARK)[1])
    assert any("rans_" in n for n in names) and any("window_attention" in n for n in names)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    summary = sum(e.count for e in prof.key_averages() if e.key.startswith("aten::"))
    assert summary <= aten <= 1.01 * summary
