"""Conv helpers, the window attention of WACNN's and stf's blocks, and
WACNN's window-attention blocks.

Port of ``icm_tpu/nn/layers.py``. Modules take NCHW tensors (cuDNN's
layout); the window blocks move to channel-last inside, where the window
partition is a reshape. Submodules carry the JAX package's parameter
names (``Conv_0``, ``attn.qkv``, ``trunk0`` ...), so a flax parameter
path maps to a state-dict key one to one (``convert.from_jax_params``).
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .window_attention import class_masks, window_attention, window_class_map


def conv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=kernel_size // 2)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv2d:
    return conv(in_ch, out_ch, kernel_size=3, stride=stride)


def conv1x1(in_ch: int, out_ch: int) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, 1)


def deconv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2) -> nn.ConvTranspose2d:
    """Learned upsampling, out = in * stride, with the reference's tap
    geometry: ConvTranspose2d(k, s, padding=k//2, output_padding=s-1)."""
    return nn.ConvTranspose2d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=kernel_size // 2,
                              output_padding=stride - 1)


class SubpelConv(nn.Module):
    """k x k conv (3x3 by default) + depth-to-space (CRD order, which is
    PixelShuffle)."""

    def __init__(self, in_ch: int, out_ch: int, r: int = 1, kernel_size: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch * r * r, kernel_size,
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
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
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
            nn.Conv2d: "Conv", nn.ConvTranspose2d: "ConvTranspose",
        }.get(type(layer), type(layer).__name__)
        if not any(True for _ in layer.parameters()):
            kind = f"{kind}_act"
        i = counts.get(kind, 0)
        counts[kind] = i + 1
        named.append((f"{kind}_{i}", layer))
    return nn.Sequential(OrderedDict(named))
