"""Conv helpers, the window attention of WACNN's and stf's blocks, and
WACNN's window-attention blocks.

Port of ``icm_tpu/nn/layers.py``. Modules take NCHW tensors (cuDNN's
layout); the window blocks move to channel-last inside, where the window
partition is a reshape. Submodules carry the JAX package's parameter
names (``Conv_0``, ``attn.qkv``, ``trunk0`` ...), so a flax parameter
path maps to a state-dict key one to one (``convert.from_jax_params``).

The activation-dtype policy (:func:`set_activation_dtype`, the JAX
package's ``icm_tpu/nn/layers.py:168-186``) lives here: every
:class:`Conv2d`, :class:`ConvTranspose2d` and :class:`Linear` of the
transforms casts its input, weight and bias to the policy dtype and
returns that dtype, as flax's ``dtype=activation_dtype()`` does, and adds
the bias after the product is rounded, as flax does; the parameters stay
float32 masters. It is done with these explicit casts
and not with ``torch.autocast``, whose op lists differ from flax's
promotion: flax's LayerNorm (no ``dtype``) returns float32 for a bfloat16
input (:class:`LayerNorm` here does the same), GDN keeps beta in float32,
and a float32 residual plus a bfloat16 branch stays float32. Without
autograd (serving, evaluation) each layer keeps its parameters' bfloat16
casts between calls and casts again only when a parameter changes
(:func:`_param_as`).
"""

from __future__ import annotations

import functools
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .window_attention import class_masks, window_attention, window_class_map

_ACT_DTYPE: Optional[torch.dtype] = None  # None: float32 throughout
# the layers holding parameter casts (:func:`_param_as`); a policy change
# drops them all
_CAST_HOLDERS: "weakref.WeakSet[nn.Module]" = weakref.WeakSet()


def set_activation_dtype(value: Optional[torch.dtype]) -> None:
    """Mixed-precision policy for the transform stacks: ``torch.bfloat16``
    runs the convolutions, transposed convolutions and dense layers
    (attention projections included) in bfloat16, their parameters cast
    from the float32 masters; ``None`` restores float32 bit for
    bit. LayerNorm, softmax, GDN's sums and the entropy models' math stay
    float32. Read at forward time (the counterpart of JAX's trace time),
    so set it before a forward, and set the same policy on both sides of
    a coder: the wire does not record it. Every parameter cast the layers
    keep is dropped here."""
    global _ACT_DTYPE
    if value is not None and not (isinstance(value, torch.dtype) and value.is_floating_point):
        raise ValueError(f"activation dtype must be None or a floating torch.dtype, got {value!r}")
    _ACT_DTYPE = value
    for module in list(_CAST_HOLDERS):
        module.__dict__.pop("_param_casts", None)
    _CAST_HOLDERS.clear()


def activation_dtype() -> Optional[torch.dtype]:
    return _ACT_DTYPE


def _param_as(module: nn.Module, name: str, dtype) -> Optional[torch.Tensor]:
    """``module``'s parameter ``name`` in ``dtype``. Under autograd a cast
    made per call (it is part of the graph); without it one cast kept per
    parameter and made again when the parameter changes: its version (any
    in-place update: an optimizer step, ``load_state_dict``) or its storage
    (a move to another device), and dropped at a policy change. The same
    bits either way."""
    p = getattr(module, name)
    if p is None:
        return None
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    key = (p._version, p.data_ptr(), p.device, dtype)
    casts = module.__dict__.get("_param_casts")
    if casts is None:
        casts = module.__dict__["_param_casts"] = {}
        _CAST_HOLDERS.add(module)
    hit = casts.get(name)
    if hit is None or hit[0] != key:
        hit = casts[name] = (key, p.detach().to(dtype))
    return hit[1]


def _add_bias(y: torch.Tensor, module: nn.Module, dtype, channel_dim: int) -> torch.Tensor:
    """``y + bias`` in ``dtype``, after the product was rounded to it, as
    flax adds it (``y += bias``): PyTorch fuses a bias into some products
    and not others (oneDNN on the CPU and cuBLAS do; cuDNN does not), which
    in bfloat16 rounds once or twice."""
    bias = _param_as(module, "bias", dtype)
    if bias is None:
        return y
    return y + bias.reshape((-1,) + (1,) * (y.dim() - 1 - channel_dim))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` under the activation-dtype policy."""

    def forward(self, x):
        dt = _ACT_DTYPE
        if dt is None:
            return super().forward(x)
        return _add_bias(self._conv_forward(x.to(dt), _param_as(self, "weight", dt), None),
                         self, dt, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` under the activation-dtype policy (no
    ``output_size``: the geometry is fixed by ``output_padding``)."""

    def forward(self, x):
        dt = _ACT_DTYPE
        if dt is None:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), _param_as(self, "weight", dt), None, self.stride,
                               self.padding, self.output_padding, self.groups, self.dilation)
        return _add_bias(y, self, dt, 1)


class Linear(nn.Linear):
    """``nn.Linear`` under the activation-dtype policy."""

    def forward(self, x):
        dt = _ACT_DTYPE
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), _param_as(self, "weight", dt))
        return _add_bias(y, self, dt, y.dim() - 1)


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm`` without a ``dtype``: a bfloat16 input is
    promoted to its float32 scale's dtype, so it computes and returns
    float32 (torch's own returns the input's dtype)."""

    def forward(self, x):
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


def conv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2) -> Conv2d:
    return Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=kernel_size // 2)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1) -> Conv2d:
    return conv(in_ch, out_ch, kernel_size=3, stride=stride)


def conv1x1(in_ch: int, out_ch: int) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1)


def deconv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2) -> ConvTranspose2d:
    """Learned upsampling, out = in * stride, with the reference's tap
    geometry: ConvTranspose2d(k, s, padding=k//2, output_padding=s-1)."""
    return ConvTranspose2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=kernel_size // 2, output_padding=stride - 1)


class SubpelConv(nn.Module):
    """k x k conv (3x3 by default) + depth-to-space (CRD order, which is
    PixelShuffle)."""

    def __init__(self, in_ch: int, out_ch: int, r: int = 1, kernel_size: int = 3):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, out_ch * r * r, kernel_size,
                             padding=kernel_size // 2)
        self.r = r

    def forward(self, x):
        x = self.Conv_0(x)
        return F.pixel_shuffle(x, self.r) if self.r > 1 else x


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws, ws, C)."""
    B, H, W, C = x.shape
    ws = window_size
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def window_reverse(windows: torch.Tensor, window_size: int, H: int, W: int) -> torch.Tensor:
    """(B * nH * nW, ws, ws, C) -> (B, H, W, C)."""
    ws = window_size
    nH, nW = H // ws, W // ws
    B = windows.shape[0] // (nH * nW)
    x = windows.reshape(B, nH, nW, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


@functools.lru_cache(maxsize=64)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static (wh*ww, wh*ww) index into the (2wh-1)(2ww-1) bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def shifted_window_mask(H: int, W: int, window_size: int, shift_size: int) -> np.ndarray:
    """Static SW-MSA mask (nW, N, N) with 0 / -100 entries."""
    img_mask = np.zeros((H, W), np.int32)
    slices = (
        slice(0, -window_size),
        slice(-window_size, -shift_size),
        slice(-shift_size, None),
    )
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    nH, nW = H // window_size, W // window_size
    mw = img_mask.reshape(nH, window_size, nW, window_size)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """W-MSA over flattened windows with a relative-position bias.

    The bias and the per-class shifted-window masks are folded into one
    (n_cls, heads, N, N) table and the attention runs in
    :func:`window_attention` (the CUDA kernel on the card)."""

    def __init__(self, dim: int, window_size: Tuple[int, int], num_heads: int):
        super().__init__()
        self.dim = dim
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        wh, ww = self.window_size
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads)
        )
        self._index_cache: Dict[str, torch.Tensor] = {}

    def _bias_index(self, device) -> torch.Tensor:
        """The static relative-position index on ``device``, uploaded once
        (kept out of the buffers so that a model built on the meta device
        and materialized with ``to_empty`` keeps it)."""
        idx = self._index_cache.get(str(device))
        if idx is None:
            wh, ww = self.window_size
            idx = torch.from_numpy(relative_position_index(wh, ww).reshape(-1))
            idx = self._index_cache[str(device)] = idx.to(device)
        return idx

    def forward(self, x, cls_masks: torch.Tensor, cls_idx: torch.Tensor):
        """x: (B_, N, C); cls_masks: (n_cls, N, N) f32; cls_idx: (B_,) int32."""
        B_, N, C = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(B_, N, 3, nh, C // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B_, nh, N, hd)
        bias = self.relative_position_bias_table[self._bias_index(x.device)]
        bias = bias.reshape(N, N, nh).permute(2, 0, 1)  # (nh, N, N)
        bias_cls = bias[None].float() + cls_masks[:, None]  # (n_cls, nh, N, N)
        out = window_attention(q, k, v, bias_cls, cls_idx)
        out = out.transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class ShiftedWindows(nn.Module):
    """Base of the (shifted-)window attention blocks: the window geometry
    and its class tables."""

    def __init__(self, window_size: int, shift_size: int):
        super().__init__()
        if not 0 <= shift_size < window_size:
            raise ValueError(f"shift {shift_size} outside [0, {window_size})")
        self.window_size = window_size
        self.shift_size = shift_size
        self._cls_cache: Dict[tuple, tuple] = {}

    def _classes(self, H: int, W: int, B: int, device):
        """(class masks, class per window) tensors on ``device``, made once
        per shape so the coder's loop uploads nothing."""
        key = (H, W, B, str(device))
        hit = self._cls_cache.get(key)
        if hit is None:
            ws, ss = self.window_size, self.shift_size
            _, cls = window_class_map(H, W, ws, ss)
            masks = torch.from_numpy(class_masks(H, W, ws, ss)).to(device)
            cls_idx = torch.from_numpy(np.tile(cls, B)).to(device)
            hit = self._cls_cache[key] = (masks, cls_idx)
        return hit


class WinBasedAttention(ShiftedWindows):
    """Residual (shifted-)window attention block (no MLP)."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0):
        super().__init__(window_size, shift_size)
        self.attn = WindowAttention(dim, (window_size, window_size), num_heads)

    def forward(self, x):
        B, C, H, W = x.shape
        ws, ss = self.window_size, self.shift_size
        if H % ws or W % ws:
            raise ValueError(f"{H}x{W} is not a multiple of window {ws}")
        shortcut = x
        x = x.permute(0, 2, 3, 1)  # NHWC
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        masks, cls_idx = self._classes(H, W, B, x.device)
        xw = window_partition(x, ws).reshape(-1, ws * ws, C)
        attn = self.attn(xw, masks, cls_idx)
        x = window_reverse(attn.reshape(-1, ws, ws, C), ws, H, W)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        return shortcut + x.permute(0, 3, 1, 2)


class ResidualUnit(nn.Module):
    """1x1 -> GELU -> 3x3 -> GELU -> 1x1 bottleneck, residual, GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = conv1x1(dim, dim // 2)
        self.Conv_1 = conv3x3(dim // 2, dim // 2)
        self.Conv_2 = conv1x1(dim // 2, dim)

    def forward(self, x):
        out = F.gelu(self.Conv_0(x))
        out = F.gelu(self.Conv_1(out))
        return F.gelu(self.Conv_2(out) + x)


class Win_noShift_Attention(nn.Module):
    """Gated window-attention residual block: a trunk of 3 residual units
    times the sigmoid of an attention branch, plus the identity."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0):
        super().__init__()
        for i in range(3):
            self.add_module(f"trunk{i}", ResidualUnit(dim))
        self.win_attn = WinBasedAttention(dim, num_heads, window_size, shift_size)
        for i in range(3):
            self.add_module(f"branch{i}", ResidualUnit(dim))
        self.Conv_0 = conv1x1(dim, dim)

    def forward(self, x):
        a = x
        for i in range(3):
            a = getattr(self, f"trunk{i}")(a)
        b = self.win_attn(x)
        for i in range(3):
            b = getattr(self, f"branch{i}")(b)
        b = self.Conv_0(b)
        return x + a * torch.sigmoid(b)


def named_sequential(*layers) -> nn.Sequential:
    """nn.Sequential whose children are named as flax names them: one
    counter per class name (``Conv_0``, ``GDN_0``, ``Conv_1`` ...);
    parameter-free layers get ``<name>_act<i>``."""
    counts: Dict[str, int] = {}
    named = []
    for layer in layers:
        kind = {
            Conv2d: "Conv", ConvTranspose2d: "ConvTranspose",
        }.get(type(layer), type(layer).__name__)
        if not any(True for _ in layer.parameters()):
            kind = f"{kind}_act"
        i = counts.get(kind, 0)
        counts[kind] = i + 1
        named.append((f"{kind}_{i}", layer))
    return nn.Sequential(OrderedDict(named))
