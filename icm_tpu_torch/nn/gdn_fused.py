"""Fused GDN / IGDN: the CUDA kernels, their wrappers and their plain
PyTorch versions.

Port of ``icm_tpu/nn/gdn_pallas.py``. For x of shape (B, C, H, W), gamma
(C_out, C_in) and beta (C,), all float32, the forward is

    n = beta + gamma . x^2   (over channels, per pixel)
    y = x * n^(-1/2)         (inverse, IGDN: x * n^(+1/2))

and the backward takes the cotangent g of y and returns dx, dgamma (in
gamma's (C_out, C_in) orientation) and dbeta, recomputing n from x, gamma
and beta as the Pallas backward does (``gdn_pallas.py:150-153``).

- :func:`gdn_forward_reference` and :func:`gdn_backward_reference` are the
  plain versions: the CPU path, and what the kernels are held against on
  the card.
- :func:`gdn_forward_cuda` and :func:`gdn_backward_cuda` launch
  ``csrc/gdn.cu`` on the current stream (built with nvcc at first use and
  loaded with ctypes). They take contiguous float32 CUDA tensors only and
  raise on anything else; ``FWD_LAUNCHES`` and ``BWD_LAUNCHES`` count
  their calls (the backward's call launches three kernels: dx and dn, the
  partial sums of dgamma and dbeta, and their fixed-order reduce).
- :func:`gdn` is what ``GDN.forward`` calls, on every device: an autograd
  function whose forward and backward are the kernels for a CUDA tensor
  and the plain versions for a CPU tensor.

The JAX package takes its Pallas backward only where the row count has a
power-of-two tile (``gdn_pallas.py:102-110``) and runs the forward as an
einsum; on a CUDA tensor the port launches both kernels at every row
count.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from .. import _native

# calls of the CUDA kernels in this process; chip_smoke.py zeroes them
# before driving a path and reads them after
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

# channels the kernels take. Up to 192 (every GDN of every model) both keep
# gamma resident in shared memory and run their products on the tensor
# cores. Above, the backward streams gamma, its two (C x 24) float tiles
# and two gamma chunks fitting a block's 227 KB of shared memory up to
# C = 896, and the forward stages gamma in chunks on the f32 FMA units
# (beyond C = 1,600)
MAX_CHANNELS = 512

_fns = None
_fns_lock = threading.Lock()


def _kernel_fns():
    global _fns
    with _fns_lock:
        if _fns is None:
            lib = _native.load("gdn")
            fwd = lib.gdn_forward
            fwd.restype = ctypes.c_int
            fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            bwd = lib.gdn_backward
            bwd.restype = ctypes.c_int
            bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            workspace = lib.gdn_backward_workspace
            workspace.restype = ctypes.c_longlong
            workspace.argtypes = [ctypes.c_int] * 3
            _fns = (fwd, bwd, workspace)
        return _fns


def _normalizer(s, gamma, beta):
    """n = beta + gamma . s over channels, s = x^2, as a 1x1 convolution
    (gamma is (C_out, C_in))."""
    C = gamma.shape[0]
    return F.conv2d(s, gamma.reshape(C, C, 1, 1), beta)


def gdn_forward_reference(x, gamma, beta, inverse: bool):
    """Plain forward: ``x * rsqrt(n)`` (inverse: ``x * sqrt(n)``)."""
    n = _normalizer(x * x, gamma, beta)
    return x * (torch.sqrt(n) if inverse else torch.rsqrt(n))


def gdn_backward_reference(g, x, gamma, beta, inverse: bool):
    """Plain backward with the Pallas kernel's formulas
    (``gdn_pallas.py:64-99``) -> (dx, dgamma (C_out, C_in), dbeta)."""
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
    return dx, dgamma, dbeta


def _check(x, gamma, beta, g=None):
    tensors = [("x", x), ("gamma", gamma), ("beta", beta)]
    if g is not None:
        tensors.append(("g", g))
    for name, t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    """Launch the fused forward kernel. x: (B, C, H, W); gamma (C, C) as
    (C_out, C_in); beta (C,); contiguous float32 CUDA tensors on one
    device. Returns a new (B, C, H, W)."""
    global FWD_LAUNCHES
    _check(x, gamma, beta)
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    fwd, _, _ = _kernel_fns()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
                 B, C, H * W, int(inverse), stream)
    if rc != 0:
        raise RuntimeError(f"gdn forward kernel launch failed (code {rc})")
    FWD_LAUNCHES += 1
    return y


def gdn_backward_cuda(g, x, gamma, beta, inverse: bool):
    """Launch the fused backward (dx and dn, then dgamma and dbeta as
    partial sums over fixed pixel ranges, then their fixed-order reduce).
    g, x: (B, C, H, W); gamma (C, C) as (C_out, C_in); beta (C,);
    contiguous float32 CUDA tensors on one device. Returns (dx, dgamma
    (C_out, C_in), dbeta)."""
    global BWD_LAUNCHES
    _check(x, gamma, beta, g)
    B, C, H, W = x.shape
    _, bwd, workspace_floats = _kernel_fns()
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    # dn (B x C x H x W) and the partial sums of dgamma and dbeta
    workspace = torch.empty(max(workspace_floats(B, C, H * W), 1), dtype=torch.float32,
                            device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = bwd(g.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                 workspace.data_ptr(), B, C, H * W, int(inverse), stream)
    if rc != 0:
        raise RuntimeError(f"gdn backward kernel launch failed (code {rc})")
    BWD_LAUNCHES += 1
    return dx, dgamma, dbeta


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
    (already reparametrized) gamma (C_out, C_in) and beta (C,). Inputs are
    made contiguous here."""
    return _GDNFn.apply(x.contiguous(), gamma.contiguous(), beta.contiguous(),
                        bool(inverse))
