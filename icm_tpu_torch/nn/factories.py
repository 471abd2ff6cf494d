"""Shared CNN transforms of the CRC family (and of WACNN's hyper and
context part).

Port of ``icm_tpu/nn/factories.py``: the WACNN-style conv + GDN +
window-attention encoder and decoders (the decoder whole and in its two
halves), the hyper-encoder and hyper-decoder stacks, and the per-slice
context stacks. Each is an ``nn.Sequential`` whose children carry the
flax names (``Conv_0``, ``GDN_1``, ``Win_noShift_Attention_0`` ...), so
``convert.from_jax_params`` maps a JAX subtree one to one; NCHW in and
out. ``ContextScale1`` and ``ContextScale2`` come with ``stf12`` and
``stf13``.

Window attention runs at head width N / 8 and M / 8 in the encoder, M / 8
and mid / 8 in the decoders: 24, 48 and 32 at the published N = 192,
M = 384, mid = 256; the decoders' 256-channel IGDN is the fused GDN at
C = 256.
"""

from __future__ import annotations

from typing import Tuple

import torch.nn.functional as F
from torch import nn

from .gdn import GDN
from .layers import SubpelConv, Win_noShift_Attention, conv, conv3x3, deconv, named_sequential


class Gelu(nn.Module):
    """Exact GELU as a layer of a stack."""

    def forward(self, x):
        return F.gelu(x)


def main_cnn_encoder(N: int = 192, M: int = 384, in_ch: int = 3) -> nn.Sequential:
    """``MainCNNEncoder`` (WACNN's analysis): 4 stride-2 5x5 convs with GDN
    after the first three, window attention (window 8, shift 4) after the
    second and (window 4, shift 2) after the last."""
    return named_sequential(
        conv(in_ch, N, 5, 2), GDN(N),
        conv(N, N, 5, 2), GDN(N),
        Win_noShift_Attention(N, num_heads=8, window_size=8, shift_size=4),
        conv(N, N, 5, 2), GDN(N),
        conv(N, M, 5, 2),
        Win_noShift_Attention(M, num_heads=8, window_size=4, shift_size=2),
    )


def _decoder_part1(N: int, M: int, mid: int) -> list:
    return [
        Win_noShift_Attention(M, num_heads=8, window_size=4, shift_size=2),
        deconv(M, N, 5, 2), GDN(N, inverse=True),
        deconv(N, mid, 5, 2), GDN(mid, inverse=True),
        Win_noShift_Attention(mid, num_heads=8, window_size=8, shift_size=4),
    ]


def _decoder_part2(N: int, mid: int, out_ch: int) -> list:
    return [deconv(mid, N, 5, 2), GDN(N, inverse=True), deconv(N, out_ch, 5, 2)]


def main_cnn_decoder(N: int = 192, M: int = 384, mid: int = 256, out_ch: int = 3,
                     in_mult: int = 1) -> nn.Sequential:
    """``MainCNNDecoder``: latent (M * in_mult channels) -> image, x16."""
    return named_sequential(*_decoder_part1(N, M * in_mult, mid),
                            *_decoder_part2(N, mid, out_ch))


def main_cnn_decoder_part1(N: int = 192, M: int = 384, mid: int = 256) -> nn.Sequential:
    """``MainCNNDecoderPart1``: the decoder's first half, ``mid`` channels at
    a quarter of the image's scale."""
    return named_sequential(*_decoder_part1(N, M, mid))


def main_cnn_decoder_part2(N: int = 192, mid: int = 256, out_ch: int = 3) -> nn.Sequential:
    """``MainCNNDecoderPart2``: the second half, x4 to the image."""
    return named_sequential(*_decoder_part2(N, mid, out_ch))


def hyper_encoder(in_ch: int, widths: Tuple[int, ...]) -> nn.Sequential:
    """``HyperEncoder384``: 3x3 convs with strides 1, 1, 2, 1, 2 and GELU
    between."""
    layers, c = [], in_ch
    for i, (w, s) in enumerate(zip(widths, (1, 1, 2, 1, 2))):
        if i > 0:
            layers.append(Gelu())
        layers.append(conv3x3(c, w, stride=s))
        c = w
    return named_sequential(*layers)


def hyper_mean(in_ch: int, widths: Tuple[int, ...], extra_convs: int = 0) -> nn.Sequential:
    """``HyperMean384``: conv and sub-pixel 2x stack, x4; ``extra_convs``
    GELU + 3x3 conv pairs at the last width after it (the human layers'
    hyper-decoders have five)."""
    w = widths
    layers = [
        conv3x3(in_ch, w[0]), Gelu(),
        SubpelConv(w[0], w[1], r=2), Gelu(),
        conv3x3(w[1], w[2]), Gelu(),
        SubpelConv(w[2], w[3], r=2), Gelu(),
        conv3x3(w[3], w[4]),
    ]
    for _ in range(extra_convs):
        layers += [Gelu(), conv(w[4], w[4], kernel_size=3, stride=1)]
    return named_sequential(*layers)


def shallow_cc(in_ch: int, out_ch: int, widths: Tuple[int, ...]) -> nn.Sequential:
    """``ShallowCC``: a per-slice context stack of 3x3 convs through
    ``widths`` to ``out_ch``, GELU between."""
    layers, c = [], in_ch
    for w in widths:
        layers += [conv(c, w, kernel_size=3, stride=1), Gelu()]
        c = w
    layers.append(conv(c, out_ch, kernel_size=3, stride=1))
    return named_sequential(*layers)
