"""ResNet backbones for the ICM task networks.

Port of ``icm_tpu/tasks/resnet.py`` (``BasicBlock``, ``Bottleneck``,
``ResNetBackbone`` and ``resnet18`` ... ``resnet152``): the torchvision
stage layout, the stage features (C2, C3, C4, C5) returned, and
``output_stride`` 16 or 8 turning the later stages into dilated
convolutions (DeepLab's). Modules take and give NCHW tensors. Submodules
carry flax's auto-names (``Conv_0``, ``BatchNorm_0``, ``layer1_0`` ...),
so ``convert.from_jax_params`` maps a flax tree by path.

BatchNorm runs on its stored statistics only (:class:`FrozenBatchNorm2d`),
as the JAX nets do (``use_running_average=True``): ``model.train()``
neither switches it to batch statistics nor moves its buffers.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5  # flax's BatchNorm epsilon


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm over NCHW channels, in flax's order:
    ``(x - mean) * (weight * rsqrt(var + 1e-5)) + bias``. ``weight`` and
    ``bias`` are parameters (flax's ``scale`` and ``bias``), ``mean`` and
    ``var`` buffers (flax's ``batch_stats``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """flax's init: scale 1, bias 0, mean 0, var 1 (no draw)."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + EPS) * self.weight
        return (x - self.mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, dilation: int = 1) -> nn.Conv2d:
    """flax's bias-free ``nn.Conv``: a 3x3 or 7x7 padded by its dilated
    half width, a 1x1 unpadded (its "SAME" at any stride)."""
    pad = dilation * (k // 2)
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=pad, dilation=dilation, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.Conv_0 = _conv(in_ch, features, 3, stride, dilation)
        self.BatchNorm_0 = FrozenBatchNorm2d(features)
        self.Conv_1 = _conv(features, features, 3, 1, dilation)
        self.BatchNorm_1 = FrozenBatchNorm2d(features)
        self.downsample = downsample
        if downsample:
            self.Conv_2 = _conv(in_ch, features, 1, stride)
            self.BatchNorm_2 = FrozenBatchNorm2d(features)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        identity = self.BatchNorm_2(self.Conv_2(x)) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, dilation: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = features * 4
        self.Conv_0 = _conv(in_ch, features, 1)
        self.BatchNorm_0 = FrozenBatchNorm2d(features)
        self.Conv_1 = _conv(features, features, 3, stride, dilation)
        self.BatchNorm_1 = FrozenBatchNorm2d(features)
        self.Conv_2 = _conv(features, out_ch, 1)
        self.BatchNorm_2 = FrozenBatchNorm2d(out_ch)
        self.downsample = downsample
        if downsample:
            self.Conv_3 = _conv(in_ch, out_ch, 1, stride)
            self.BatchNorm_3 = FrozenBatchNorm2d(out_ch)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        identity = self.BatchNorm_3(self.Conv_3(x)) if self.downsample else x
        return F.relu(out + identity)


class ResNetBackbone(nn.Module):
    """Stem (7x7 stride 2, BatchNorm, ReLU, 3x3 max-pool stride 2), then
    four stages of widths 64, 128, 256, 512 (x4 for bottlenecks).
    ``forward`` returns the stages' outputs [C2, C3, C4, C5]."""

    def __init__(self, block: str = "bottleneck", layers: Tuple[int, ...] = (3, 4, 6, 3),
                 output_stride: int = 32):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block must be 'basic' or 'bottleneck', got {block!r}")
        Block = Bottleneck if block == "bottleneck" else BasicBlock
        self.layers = tuple(layers)
        self.Conv_0 = _conv(3, 64, 7, 2)
        self.BatchNorm_0 = FrozenBatchNorm2d(64)
        strides, dilations = [1, 2, 2, 2], [1, 1, 1, 1]
        if output_stride == 16:
            strides[3], dilations[3] = 1, 2
        elif output_stride == 8:
            strides[2], dilations[2] = 1, 2
            strides[3], dilations[3] = 1, 4
        elif output_stride != 32:
            raise ValueError(f"output_stride must be 32, 16 or 8, got {output_stride}")
        in_ch = 64
        for si, (w, n) in enumerate(zip((64, 128, 256, 512), self.layers)):
            for bi in range(n):
                stride = strides[si] if bi == 0 else 1
                out_ch = w * Block.expansion
                need_ds = bi == 0 and (stride != 1 or in_ch != out_ch)
                self.add_module(f"layer{si + 1}_{bi}",
                                Block(in_ch, w, stride, dilations[si], need_ds))
                in_ch = out_ch
        self.out_channels = in_ch

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for si, n in enumerate(self.layers):
            for bi in range(n):
                x = getattr(self, f"layer{si + 1}_{bi}")(x)
            feats.append(x)
        return feats


def resnet18(**kw) -> ResNetBackbone:
    return ResNetBackbone(block="basic", layers=(2, 2, 2, 2), **kw)


def resnet34(**kw) -> ResNetBackbone:
    return ResNetBackbone(block="basic", layers=(3, 4, 6, 3), **kw)


def resnet50(**kw) -> ResNetBackbone:
    return ResNetBackbone(block="bottleneck", layers=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNetBackbone:
    return ResNetBackbone(block="bottleneck", layers=(3, 4, 23, 3), **kw)


def resnet152(**kw) -> ResNetBackbone:
    return ResNetBackbone(block="bottleneck", layers=(3, 8, 36, 3), **kw)
