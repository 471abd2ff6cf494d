"""Fused GDN / IGDN: the CUDA kernels, their wrappers and their plain
PyTorch versions.

Port of ``icm_tpu/nn/gdn_pallas.py``. For x of shape (B, C, H, W), gamma
(C_out, C_in) and beta (C,), the forward is

    n = beta + gamma . x^2   (over channels, per pixel)
    y = x * n^(-1/2)         (inverse, IGDN: x * n^(+1/2))

and the backward takes the cotangent g of y and returns dx, dgamma (in
gamma's (C_out, C_in) orientation) and dbeta, recomputing n from x, gamma
and beta as the Pallas backward does (``gdn_pallas.py:150-153``).

Types, as the Pallas kernels take them (``gdn_pallas.py:50-99,176-183``):
x and g float32 or bfloat16, gamma in x's dtype, beta float32. Everything
inside is float32 (gamma's bfloat16 values exactly); y and dx come out in
x's dtype, rounded once, dgamma in gamma's dtype and dbeta in float32.
In float32 every cast is the identity.

- :func:`gdn_forward_reference` and :func:`gdn_backward_reference` are the
  plain versions: the CPU path, and what the kernels are held against on
  the card.
- :func:`gdn_forward_cuda` and :func:`gdn_backward_cuda` launch
  ``csrc/gdn.cu`` on the current stream (built with nvcc at first use and
  loaded with ctypes), its float32 or its bfloat16 build by x's dtype.
  They take contiguous CUDA tensors only and raise on anything else;
  ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count their calls by x's dtype
  and channels (the backward's call launches three kernels: dx and dn,
  the partial sums of dgamma and dbeta, and their fixed-order reduce).
- :func:`gdn` is what ``GDN.forward`` calls, on every device: an autograd
  function whose forward and backward are the kernels for a CUDA tensor
  and the plain versions for a CPU tensor.

The JAX package takes its Pallas backward only where the row count has a
power-of-two tile (``gdn_pallas.py:102-110``) and runs the forward as an
einsum, which in bfloat16 rounds x^2, n and its root to bfloat16 as well
(``_einsum_fwd``); on a CUDA tensor the port launches both kernels at
every row count, and follows the kernels' numerics.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter

import torch
import torch.nn.functional as F

from .. import _native

# calls of the CUDA kernels in this process, by (x's dtype, channels): the
# build launched, and above 192 channels another design (MAX_CHANNELS'
# note); chip_smoke.py clears them before driving a path and reads them
# after (``graphs.by_dtype`` sums the channels)
FWD_LAUNCHES: Counter = Counter()
BWD_LAUNCHES: Counter = Counter()

# channels the kernels take. Up to 192 (every GDN but the CRC family's
# 256-channel IGDN in MainCNNDecoder) both keep
# gamma resident in shared memory and run their products on the tensor
# cores. Above, the backward streams gamma, its two (C x 24) float tiles
# and two gamma chunks fitting a block's 227 KB of shared memory up to
# C = 896, and the forward stages gamma in chunks on the f32 FMA units
# (beyond C = 1,600)
MAX_CHANNELS = 512

# the kernels' element type of x, g, y and dx: the C entries' dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fns = None
_fns_lock = threading.Lock()


def _kernel_fns():
    global _fns
    with _fns_lock:
        if _fns is None:
            lib = _native.load("gdn")
            fwd = lib.gdn_forward
            fwd.restype = ctypes.c_int
            fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            bwd = lib.gdn_backward
            bwd.restype = ctypes.c_int
            bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            workspace = lib.gdn_backward_workspace
            workspace.restype = ctypes.c_longlong
            workspace.argtypes = [ctypes.c_int] * 4
            _fns = (fwd, bwd, workspace)
        return _fns


def _normalizer(s, gamma, beta):
    """n = beta + gamma . s over channels, s = x^2, as a 1x1 convolution
    (gamma is (C_out, C_in))."""
    C = gamma.shape[0]
    return F.conv2d(s, gamma.reshape(C, C, 1, 1), beta)


def _compute_dtype(x):
    """float32 for bfloat16 and float32 inputs (float64 stays float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def gdn_forward_reference(x, gamma, beta, inverse: bool):
    """Plain forward: ``x * rsqrt(n)`` (inverse: ``x * sqrt(n)``), in
    float32, y in x's dtype."""
    dt = _compute_dtype(x)
    xf = x.to(dt)
    n = _normalizer(xf * xf, gamma.to(dt), beta.to(dt))
    return (xf * (torch.sqrt(n) if inverse else torch.rsqrt(n))).to(x.dtype)


def gdn_backward_reference(g, x, gamma, beta, inverse: bool):
    """Plain backward with the Pallas kernel's formulas
    (``gdn_pallas.py:64-99``), in float32 -> (dx in x's dtype, dgamma
    (C_out, C_in) in gamma's, dbeta in beta's)."""
    out_dtypes = (x.dtype, gamma.dtype, beta.dtype)
    dt = _compute_dtype(x)
    g, x, gamma, beta = (t.to(dt) for t in (g, x, gamma, beta))
    C = gamma.shape[0]
    s = x * x
    n = _normalizer(s, gamma, beta)
    r = torch.rsqrt(n)
    if inverse:
        direct = g * (n * r)
        dn = 0.5 * g * x * r
    else:
        direct = g * r
        dn = -0.5 * g * x * (r * r * r)
    ds = F.conv2d(dn, gamma.t().reshape(C, C, 1, 1))
    dx = direct + 2.0 * x * ds
    dgamma = torch.einsum("bohw,bihw->oi", dn, s)
    dbeta = dn.sum(dim=(0, 2, 3))
    return tuple(t.to(dt) for t, dt in zip((dx, dgamma, dbeta), out_dtypes))


def _check(x, gamma, beta, g=None):
    tensors = [("x", x), ("gamma", gamma), ("beta", beta)]
    if g is not None:
        tensors.append(("g", g))
    for name, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t, want in (("gamma", gamma, x.dtype), ("g", g, x.dtype),
                          ("beta", beta, torch.float32)):
        if t is not None and t.dtype != want:
            raise ValueError(f"{name} must be {want} (x is {x.dtype}), got {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    C = x.shape[1]
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{C} channels; the kernels take 1..{MAX_CHANNELS}")
    if gamma.shape != (C, C) or beta.shape != (C,):
        raise ValueError(f"gamma must be ({C}, {C}) and beta ({C},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    if g is not None and g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} must have x's shape {tuple(x.shape)}")


def gdn_forward_cuda(x, gamma, beta, inverse: bool):
    """Launch the fused forward kernel. x: (B, C, H, W) float32 or
    bfloat16; gamma (C, C) as (C_out, C_in) in x's dtype; beta (C,)
    float32; contiguous CUDA tensors on one device. Returns a new
    (B, C, H, W) in x's dtype."""
    _check(x, gamma, beta)
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    gamma = gamma.float()  # the kernels hold gamma in float32
    fwd, _, _ = _kernel_fns()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                 B, C, H * W, int(inverse), _DTYPE_CODE[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gdn forward kernel launch failed (code {rc})")
    FWD_LAUNCHES[x.dtype, C] += 1
    return y


def gdn_backward_cuda(g, x, gamma, beta, inverse: bool):
    """Launch the fused backward (dx and dn, then dgamma and dbeta as
    partial sums over fixed pixel ranges, then their fixed-order reduce).
    g, x: (B, C, H, W) float32 or bfloat16; gamma (C, C) as (C_out, C_in)
    in x's dtype; beta (C,) float32; contiguous CUDA tensors on one
    device. Returns (dx in x's dtype, dgamma (C_out, C_in) in gamma's,
    dbeta float32)."""
    _check(x, gamma, beta, g)
    B, C, H, W = x.shape
    code = _DTYPE_CODE[x.dtype]
    _, bwd, workspace_floats = _kernel_fns()
    dx = torch.empty_like(x)
    gamma32 = gamma.float()  # the kernels hold gamma and its sums in float32
    dgamma = torch.empty_like(gamma32)
    dbeta = torch.empty_like(beta)
    # dn (B x C x H x W), the partial sums of dgamma and dbeta, and in
    # bfloat16 above 192 channels dx's float32 direct term
    workspace = torch.empty(max(workspace_floats(B, C, H * W, code), 1), dtype=torch.float32,
                            device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = bwd(g.data_ptr(), x.data_ptr(), gamma32.data_ptr(), beta.data_ptr(),
                 dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                 workspace.data_ptr(), B, C, H * W, int(inverse), code, stream)
    if rc != 0:
        raise RuntimeError(f"gdn backward kernel launch failed (code {rc})")
    BWD_LAUNCHES[x.dtype, C] += 1
    return dx, dgamma.to(gamma.dtype), dbeta


def gdn_forward(x, gamma, beta, inverse: bool):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return gdn_forward_cuda(x, gamma, beta, inverse)
    if x.device.type != "cpu":
        raise ValueError(f"no GDN path for device {x.device}")
    return gdn_forward_reference(x, gamma, beta, inverse)


def gdn_backward(g, x, gamma, beta, inverse: bool):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return gdn_backward_cuda(g, x, gamma, beta, inverse)
    if x.device.type != "cpu":
        raise ValueError(f"no GDN path for device {x.device}")
    return gdn_backward_reference(g, x, gamma, beta, inverse)


class _GDNFn(torch.autograd.Function):
    """Forward and backward: the kernels (or the plain versions on the
    CPU). Saves x, gamma and beta; the backward recomputes n."""

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse):
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse
        return gdn_forward(x, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = gdn_backward(g.contiguous(), x, gamma, beta, ctx.inverse)
        return dx, dgamma, dbeta, None


def gdn(x, gamma, beta, inverse: bool = False):
    """GDN (IGDN with ``inverse``) of x (B, C, H, W) with the effective
    (already reparametrized) gamma (C_out, C_in), in x's dtype, and beta
    (C,) float32. Inputs are made contiguous here."""
    return _GDNFn.apply(x.contiguous(), gamma.contiguous(), beta.contiguous(),
                        bool(inverse))
