"""Window attention with a per-window bias class: the CUDA kernel, its
wrapper, and its plain PyTorch version.

Port of ``icm_tpu/nn/pallas_kernels.py``. For q, k, v of shape
(W, H, N, D), a bias table (n_cls, H, N, N) (relative-position bias with
the shifted-window mask folded in per window class) and one int32 class
per window, it computes ``softmax(q*D^-1/2 @ k^T + bias[cls[w]]) @ v``.

- :func:`window_attention_reference` is the plain version: the CPU path,
  and what the kernel is held against on the card.
- :func:`window_attention_cuda` launches ``csrc/window_attention.cu`` on
  the current stream (built with nvcc at first use and loaded with
  ctypes). It takes CUDA tensors only and raises on anything it does not
  take; ``LAUNCHES`` counts its launches by q's dtype and head width.
- :func:`window_attention` is what the model calls: the kernel for a CUDA
  tensor, the plain version for a CPU tensor, and, for training, an
  autograd function whose backward differentiates the plain version (as
  the JAX package's ``_fused_bwd`` does).

The JAX package takes its kernel only at <= 256 windows, a TPU v5e
measurement (``fused_attention_profitable``); on a CUDA tensor the port
launches its kernel at every window count.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import Counter

import numpy as np
import torch

from .. import _native

# launches of the CUDA kernel in this process, by (q's dtype, head width):
# the build launched; chip_smoke.py clears them before driving the codec
# and reads them after (``graphs.by_dtype`` sums the widths)
LAUNCHES: Counter = Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# built in the kernel's dispatch: the zigzag family's refiners (8, 16), stf's
# (16), WACNN's (24, 40), the CRC family's MainCNN transforms (32, 48) and
# stf12's decoder head (96)
SUPPORTED_HEAD_DIMS = (8, 16, 24, 32, 40, 48, 96)
MAX_TOKENS = 128  # N: tokens per window (a row's N scores live in a quad's registers)

_fn = None
_fn_lock = threading.Lock()


def _kernel_fn():
    global _fn
    with _fn_lock:
        if _fn is None:
            lib = _native.load("kernels")
            fn = lib.window_attention_fwd
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            _fn = fn
        return _fn


def _scale(D: int, dtype: torch.dtype) -> float:
    """D^-1/2 as the JAX kernel applies it: a Python scalar takes the
    array's dtype, so under bf16 the scale itself is rounded to bf16."""
    return float(torch.tensor(D ** -0.5, dtype=dtype))


def window_attention_reference(q, k, v, bias, cls_idx):
    """Plain version with the kernel's numerics: q*scale rounded to the
    input dtype, scores and softmax in f32, probabilities rounded to v's
    dtype, PV accumulated in f32, output in the input dtype. In f32 this is
    ``icm_tpu.nn.pallas_kernels.window_attention_reference``; a float64
    input stays float64 throughout, as the JAX package's jnp attention
    keeps it (``promote_types(dtype, float32)``)."""
    return _attend(q, k, v, bias.to(_acc(q.dtype))[cls_idx.long()])


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The scores' and sums' dtype: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _attend(q, k, v, window_bias):
    """The plain version with each window's bias (W, H, N, N) f32."""
    D = q.shape[-1]
    acc = _acc(q.dtype)
    qs = q * torch.tensor(_scale(D, q.dtype), dtype=q.dtype, device=q.device)
    attn = torch.matmul(qs.to(acc), k.to(acc).transpose(-1, -2))
    attn = torch.softmax(attn + window_bias, dim=-1)
    out = torch.matmul(attn.to(v.dtype).to(acc), v.to(acc))
    return out.to(q.dtype)


def window_attention_cuda(q, k, v, bias, cls_idx):
    """Launch the CUDA kernel. q, k, v: (W, H, N, D) contiguous CUDA
    tensors of one dtype (f32 or bf16); bias: (n_cls, H, N, N) f32;
    cls_idx: (W,) int32, all on q's device. Returns a new (W, H, N, D)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), ("cls", cls_idx)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.data_ptr() % 16:  # the kernel stages rows with 16-byte copies
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (W, H, N, D) shape: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    W, H, N, D = q.shape
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head width {D} not in {SUPPORTED_HEAD_DIMS}")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"{N} tokens per window; the kernel takes 1..{MAX_TOKENS}")
    if bias.dtype != torch.float32 or bias.dim() != 4 or bias.shape[1:] != (H, N, N):
        raise ValueError(f"bias must be float32 (n_cls, {H}, {N}, {N}), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if cls_idx.dtype != torch.int32 or cls_idx.shape != (W,):
        raise ValueError(f"cls must be int32 ({W},), got {cls_idx.dtype} "
                         f"{tuple(cls_idx.shape)}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            cls_idx.data_ptr(), out.data_ptr(), W, H, N, D, bias.shape[0],
            _scale(D, q.dtype), _DTYPE_CODE[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"window_attention kernel launch failed (code {rc})")
    LAUNCHES[q.dtype, D] += 1
    return out


def _forward(q, k, v, bias, cls_idx):
    if q.is_cuda:
        return window_attention_cuda(q, k, v, bias, cls_idx)
    if q.device.type != "cpu":
        raise ValueError(f"no window-attention path for device {q.device}")
    return window_attention_reference(q, k, v, bias, cls_idx)


class _WindowAttentionFn(torch.autograd.Function):
    """Forward: kernel (or plain version on the CPU). Backward: autograd of
    the plain version, recomputed from the saved inputs, except for the
    bias: its gradient per window is summed by class in one product with
    the windows' one-hot classes. (Autograd of the gather ``bias[cls]``
    sums a class's thousands of windows one after another on the card.)"""

    @staticmethod
    def forward(ctx, q, k, v, bias, cls_idx):
        ctx.save_for_backward(q, k, v, bias, cls_idx)
        return _forward(q, k, v, bias, cls_idx)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, cls_idx = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            window_bias = bias.detach().to(_acc(q.dtype))[cls_idx.long()]
            if ctx.needs_input_grad[3]:
                ins.append(window_bias.requires_grad_(True))
            grads = torch.autograd.grad(_attend(*ins[:3], window_bias), ins,
                                        g.to(q.dtype))
        d_bias = None
        if ctx.needs_input_grad[3]:
            one_hot = torch.nn.functional.one_hot(cls_idx.long(), bias.shape[0])
            d_bias = one_hot.t().to(grads[3].dtype) @ grads[3].reshape(cls_idx.shape[0], -1)
            d_bias = d_bias.reshape(bias.shape).to(bias.dtype)
        return grads[0], grads[1], grads[2], d_bias, None


def window_attention(q, k, v, bias, cls_idx):
    """The model's entry: q, k, v (W, H, N, D); bias (n_cls, H, N, N) f32;
    cls_idx (W,) int32. Inputs are made contiguous here."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = bias.contiguous()
    cls_idx = cls_idx.contiguous()
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, bias)
    ):
        return _WindowAttentionFn.apply(q, k, v, bias, cls_idx)
    return _forward(q, k, v, bias, cls_idx)


@functools.lru_cache(maxsize=64)
def window_class_map(H: int, W: int, window_size: int, shift_size: int):
    """(n_cls, class per window) for the shifted-window mask structure:
    class = (row class, column class), where the last window row/column
    (which wraps after the cyclic shift) differs from the interior."""
    nH, nW = H // window_size, W // window_size
    if shift_size == 0:
        return 1, np.zeros(nH * nW, np.int32)
    row_cls = np.zeros(nH, np.int32)
    row_cls[-1] = 1
    col_cls = np.zeros(nW, np.int32)
    col_cls[-1] = 1
    cls = row_cls[:, None] * 2 + col_cls[None, :]
    return 4, cls.reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def class_masks(H: int, W: int, window_size: int, shift_size: int):
    """(n_cls, N, N) additive masks per window class (the rows of
    ``layers.shifted_window_mask``, one per class)."""
    from .layers import shifted_window_mask

    n_cls, cls = window_class_map(H, W, window_size, shift_size)
    N = window_size * window_size
    if shift_size == 0:
        return np.zeros((1, N, N), np.float32)
    full = shifted_window_mask(H, W, window_size, shift_size)  # (nW, N, N)
    out = np.zeros((n_cls, N, N), np.float32)
    for c in range(n_cls):
        idx = np.nonzero(cls == c)[0]
        if len(idx):
            out[c] = full[idx[0]]
    return out
