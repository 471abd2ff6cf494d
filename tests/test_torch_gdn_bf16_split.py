"""The premise of the bfloat16 GDN kernels' products (``csrc/gdn.cu``'s
bfloat16 design), held on the CPU with the split arithmetic written here:

- the square of a bfloat16 x has at most 16 significant bits, so it is
  hi + lo exactly, both bfloat16: hi its top 8 bits, lo the rest;
- a float32 value is hi + mid + lo exactly, three bfloat16 pieces;
- so the products the kernels run in bfloat16 (n = Gamma x^2 in 2 passes,
  Gamma^T dn in 3, dGamma = dn (x^2)^T in 5, the six piece products less
  lo x lo) sum the float32 version's terms, and the forward and backward
  computed from the pieces equal the plain versions to float order.

The pieces are truncations of the float32 bit pattern, as the kernels cut
them (a bfloat16 is the upper half of a float32's bits). Below 2^-118 a
square's lo piece falls under bfloat16's least normal (2^-126) and loses
the bits under its least subnormal (2^-133): at most 2^-133 a term, against
n >= beta.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from icm_tpu_torch.nn import gdn_fused as tgdn

LEAST_SUBNORMAL = 2.0 ** -133  # bfloat16's
EXACT_SQUARES_FROM = 2.0 ** -118  # a square's lo piece is a normal bfloat16 above


def trunc_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values cut to their upper 16 bits: bfloat16 values."""
    return (np.ascontiguousarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)).view(
        np.float32)


def is_bf16(a: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFF)) == 0


def square_split(x: np.ndarray):
    """x (bfloat16 values as float32) -> (hi, lo) of x^2, as the kernels'
    ``square_split``; also the unrounded remainder."""
    s = x * x
    hi = trunc_bf16(s)
    rest = s - hi
    return hi, trunc_bf16(rest), rest


def split3(a: np.ndarray):
    """float32 a -> (hi, mid, lo), as the kernels' ``split3``; also the
    last unrounded remainder."""
    hi = trunc_bf16(a)
    r = a - hi
    mid = trunc_bf16(r)
    rest = r - mid
    return hi, mid, trunc_bf16(rest), rest


def test_every_bf16_square_is_hi_plus_lo():
    x = (np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)).view(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        s = x * x
        hi, lo, rest = square_split(x)
    # squares past float32's range (|x| >= 2^64) are inf in the plain version too
    finite = np.isfinite(x) & np.isfinite(s)
    assert finite.sum() == 65536 - 2 * (1 + 127) - 2 * 64 * 128  # less NaN, inf, |x| >= 2^64
    # x^2 exact in float32 where it is a normal float32, and its lo a bfloat16
    exact = finite & (s >= EXACT_SQUARES_FROM)
    s64 = x[exact].astype(np.float64) ** 2
    assert np.array_equal(s[exact].astype(np.float64), s64)
    assert is_bf16(rest[exact]).all()
    assert np.array_equal(hi[exact].astype(np.float64) + lo[exact].astype(np.float64), s64)
    # below, the lost part is under bfloat16's least subnormal
    tiny = finite & ~exact
    assert tiny.sum() > 0
    lost = np.abs(s[tiny].astype(np.float64) - hi[tiny].astype(np.float64)
                  - lo[tiny].astype(np.float64))
    assert lost.max() < LEAST_SUBNORMAL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float32_is_three_bf16_pieces(seed):
    rng = np.random.default_rng(seed)
    n = 200_000
    # across the exponent range where every piece is a normal bfloat16
    v = (rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 2.0, n)
         * np.exp2(rng.integers(-100, 101, n))).astype(np.float32)
    v[:3] = (0.0, -0.0, np.float32(1.0 + 2.0 ** -23))  # zeros, all 24 bits
    hi, mid, lo, rest = split3(v)
    assert is_bf16(rest).all()
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert np.array_equal(total, v.astype(np.float64))
    # hi carries the top 8 bits: the rest is under 2^-7 of it
    nz = v != 0
    assert (np.abs(v[nz] - hi[nz]) < np.abs(hi[nz]) * 2.0 ** -7).all()
    # tiny dn: what is lost is under bfloat16's least subnormal
    t = (rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(-149, -100, n))).astype(np.float32)
    th, tm, tl, _ = split3(t)
    lost = np.abs(t.astype(np.float64) - th - tm.astype(np.float64) - tl.astype(np.float64))
    assert lost.max() < LEAST_SUBNORMAL


def _inputs(C, seed, B=2, H=5, W=7):
    """bfloat16 x, g and gamma (as float32 tensors of bfloat16 values), beta
    float32, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    x, g = (torch.from_numpy(trunc_bf16(rng.standard_normal((B, C, H, W)).astype(np.float32)))
            for _ in range(2))
    gamma = torch.from_numpy(trunc_bf16(
        (0.1 * np.eye(C) + 0.01 * rng.random((C, C))).astype(np.float32)))
    beta = torch.from_numpy((1.0 + 0.1 * rng.random(C)).astype(np.float32))
    return x, g, gamma, beta


def _conv(s, gamma):
    """gamma (C_out, C_in) over channels of s."""
    C = gamma.shape[0]
    return F.conv2d(s, gamma.reshape(C, C, 1, 1))


def _pieces(t, split):
    return [torch.from_numpy(p) for p in split(t.numpy())[:-1]]


def _n_from_pieces(x, gamma, beta):
    """n = beta + Gamma x^2 as two bfloat16 passes, lo then hi."""
    hi, lo = _pieces(x, square_split)
    return beta.reshape(1, -1, 1, 1) + (_conv(lo, gamma) + _conv(hi, gamma))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("C", [12, 192, 256])
def test_forward_from_pieces_is_the_plain_forward(C, inverse):
    x, _, gamma, beta = _inputs(C, seed=C + inverse)
    for piece in _pieces(x, square_split):
        assert is_bf16(piece.numpy()).all()
    n = _n_from_pieces(x, gamma, beta)
    y = x * (torch.sqrt(n) if inverse else torch.rsqrt(n))
    ref = tgdn.gdn_forward_reference(x, gamma, beta, inverse)  # float32 in, float32 out
    torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("C", [12, 192, 256])
def test_backward_from_pieces_is_the_plain_backward(C, inverse):
    x, g, gamma, beta = _inputs(C, seed=2 * C + inverse)
    n = _n_from_pieces(x, gamma, beta)
    r = torch.rsqrt(n)
    if inverse:
        direct, dn = g * (n * r), 0.5 * g * x * r
    else:
        direct, dn = g * r, -0.5 * g * x * (r * r * r)
    dh, dm, dl = _pieces(dn, split3)
    for piece in (dh, dm, dl):
        assert is_bf16(piece.numpy()).all()
    gt = gamma.t().contiguous()
    ds = _conv(dl, gt) + _conv(dm, gt) + _conv(dh, gt)  # Gamma^T dn: 3 passes
    dx = direct + 2.0 * x * ds
    sh, sl = _pieces(x, square_split)

    def outer(a, b):
        return torch.einsum("bohw,bihw->oi", a, b)

    # dGamma = dn (x^2)^T: 5 passes, all piece products but lo x lo
    dgamma = (outer(dl, sh) + outer(dm, sl) + outer(dm, sh) + outer(dh, sl) + outer(dh, sh))
    dx_ref, dgamma_ref, dbeta_ref = tgdn.gdn_backward_reference(g, x, gamma, beta, inverse)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-6, atol=1e-6)
    # sums over pixels relative to their max, as the card holds them (dn
    # differs from the plain version's in float order, and dbeta cancels)
    for got, ref in ((dgamma, dgamma_ref), (dn.sum(dim=(0, 2, 3)), dbeta_ref)):
        scale = ref.abs().max()
        torch.testing.assert_close(got / scale, ref / scale, rtol=0, atol=1e-6)
