"""SymmetricalTransFormer: the Swin-transformer codec (registry "stf").

Port of ``icm_tpu/models/stf.py`` (training and eval forwards and the
protocol the coder calls; the JAX ``scan_charm`` variant is not ported,
as for WACNN): a patch embedding (patch 2, dim 48) and a 4-stage Swin
analysis (depths 2, 2, 6, 2; heads 3, 6, 12, 24; window 4) with patch
merging between stages, to y with M = 8 * embed_dim = 384 channels; the
mirrored synthesis with patch splits, then a 5x5 sub-pixel convolution
(2x) and a 3x3 convolution to RGB (``end_conv``); a conv hyper-codec
384 -> 192; a 12-slice ChARM context with 6-slice support and LRP, the
same slice math as WACNN (``cnn.ChannelCharm``).

Every Swin block attends over 4x4 windows with head width 16, in the
CUDA window-attention kernel on the card. The Swin stacks run
channel-last inside; ``analyze`` and ``synthesize`` take and give NCHW
tensors, as the protocol does. In the training forward, stochastic depth
(rates ``linspace(0, drop_path_rate, 12)`` over each stack) draws from
the forward's generator; the coders run without one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn import SubpelConv
from ..nn.swin import BasicLayer, PatchEmbed
from .base import nchw_to_nhwc, nhwc_to_nchw
from .cnn import ChannelCharm


def _drop_path_rates(depths: Tuple[int, ...], rate: float):
    """Each stage's stochastic-depth rates: linspace(0, rate) over the
    stack's blocks, cut by stage."""
    dpr = np.linspace(0, rate, sum(depths)).tolist()
    return [dpr[sum(depths[:i]):sum(depths[:i + 1])] for i in range(len(depths))]


class _SwinAnalysis(nn.Module):
    """NCHW image -> NCHW latent (embed_dim * 2^(stages - 1) channels, /16
    at patch 2)."""

    def __init__(self, embed_dim: int, depths: Tuple[int, ...], num_heads: Tuple[int, ...],
                 window_size: int, patch_size: int, drop_path_rate: float):
        super().__init__()
        self.n = len(depths)
        self.embed = PatchEmbed(3, patch_size, embed_dim)
        for i, rates in enumerate(_drop_path_rates(depths, drop_path_rate)):
            self.add_module(f"layer{i}", BasicLayer(
                embed_dim * 2 ** i, num_heads[i], window_size, rates,
                downsample="merge" if i < self.n - 1 else None))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.embed(x)
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x, generator)
        return nhwc_to_nchw(x)


class _SwinSynthesis(nn.Module):
    """NCHW latent -> NCHW image: the Swin stages with patch splits, then
    ``up`` (5x5 conv + depth-to-space by the patch) and ``to_rgb`` (3x3)."""

    def __init__(self, embed_dim: int, depths: Tuple[int, ...], num_heads: Tuple[int, ...],
                 window_size: int, patch_size: int, drop_path_rate: float):
        super().__init__()
        self.n = len(depths)
        for i, rates in enumerate(_drop_path_rates(depths, drop_path_rate)):
            self.add_module(f"layer{i}", BasicLayer(
                embed_dim * 2 ** (self.n - 1 - i), num_heads[i], window_size, rates,
                downsample="split" if i < self.n - 1 else None))
        self.up = SubpelConv(embed_dim, embed_dim, r=patch_size, kernel_size=5)
        # flax's nn.Conv without a dtype (icm_tpu/models/stf.py:86): float32
        # under every activation policy, its input promoted
        self.to_rgb = nn.Conv2d(embed_dim, 3, 3, padding=1)

    def forward(self, y, generator: Optional[torch.Generator] = None):
        x = nchw_to_nhwc(y)
        for i in range(self.n):
            x = getattr(self, f"layer{i}")(x, generator)
        x = self.up(nhwc_to_nchw(x))
        return self.to_rgb(x.to(torch.promote_types(x.dtype, torch.float32)))


class SymmetricalTransFormer(ChannelCharm):
    def __init__(
        self,
        embed_dim: int = 48,
        depths: Tuple[int, ...] = (2, 2, 6, 2),
        num_heads: Tuple[int, ...] = (3, 6, 12, 24),
        window_size: int = 4,
        patch_size: int = 2,
        num_slices: int = 12,
        drop_path_rate: float = 0.2,
        hyper_enc_widths: Tuple[int, ...] = (384, 336, 288, 240, 192),
        hyper_dec_widths: Tuple[int, ...] = (240, 288, 336, 384, 384),
        cc_widths: Tuple[int, ...] = (224, 176, 128, 64),
    ):
        super().__init__()
        self.g_a = _SwinAnalysis(embed_dim, tuple(depths), tuple(num_heads), window_size,
                                 patch_size, drop_path_rate)
        self.g_s = _SwinSynthesis(embed_dim, tuple(reversed(depths)),
                                  tuple(reversed(num_heads)), window_size, patch_size,
                                  drop_path_rate)
        M = embed_dim * 2 ** (len(depths) - 1)
        self._build_context(M, num_slices, num_slices // 2, tuple(hyper_enc_widths),
                            tuple(hyper_dec_widths), tuple(cc_widths))

    def analyze(self, x):
        return self.forward_analyze(x)

    def synthesize(self, y_hat):
        return self.g_s(y_hat)

    def forward_analyze(self, x, generator: Optional[torch.Generator] = None):
        y = self.g_a(x, generator)
        return y, self.h_a(y)

    def forward_synthesize(self, y_hat, generator: Optional[torch.Generator] = None):
        return self.g_s(y_hat, generator)
