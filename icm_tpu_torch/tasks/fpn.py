"""Feature pyramids: RetinaNet's (P3-P7) and the Detectron2-style P2-P6.

Port of ``icm_tpu/tasks/fpn.py``:

- ``PyramidFeatures``: 1x1 laterals, a top-down path with nearest x2
  upsampling, 3x3 output convolutions; P6 a stride-2 convolution of C5, P7
  a ReLU and a stride-2 convolution of P6;
- ``FPN`` (the frozen R50-FPN task net of ``oj_ICM`` and ``seg_oj_ICM``):
  1x1 laterals with bias over C2-C5, the same top-down path, a 3x3 output
  convolution a level; P6 the max-pool of P5 with a 1x1 window at stride 2,
  which is P5's every other pixel. Returns a dict ``p2`` ... ``p6``.

NCHW in and out; submodules carry the flax names (``P5_1`` ... ``P7_2``,
``lateral2`` ... ``output5``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Each pixel repeated ``factor`` x ``factor`` times (the JAX package's
    ``_upsample_nearest``)."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


class PyramidFeatures(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048), feature_size: int = 256):
        super().__init__()
        c3, c4, c5 = in_channels
        fs = feature_size
        self.P5_1 = nn.Conv2d(c5, fs, 1)
        self.P5_2 = nn.Conv2d(fs, fs, 3, padding=1)
        self.P4_1 = nn.Conv2d(c4, fs, 1)
        self.P4_2 = nn.Conv2d(fs, fs, 3, padding=1)
        self.P3_1 = nn.Conv2d(c3, fs, 1)
        self.P3_2 = nn.Conv2d(fs, fs, 3, padding=1)
        self.P6 = nn.Conv2d(c5, fs, 3, stride=2, padding=1)
        self.P7_2 = nn.Conv2d(fs, fs, 3, stride=2, padding=1)

    def forward(self, inputs):
        C3, C4, C5 = inputs
        P5_x = self.P5_1(C5)
        P5_up = upsample_nearest(P5_x)
        P5_x = self.P5_2(P5_x)

        P4_x = self.P4_1(C4) + P5_up
        P4_up = upsample_nearest(P4_x)
        P4_x = self.P4_2(P4_x)

        P3_x = self.P3_2(self.P3_1(C3) + P4_up)
        P6_x = self.P6(C5)
        P7_x = self.P7_2(F.relu(P6_x))
        return [P3_x, P4_x, P5_x, P6_x, P7_x]


class FPN(nn.Module):
    """Detectron2-style P2-P6 pyramid over (C2, C3, C4, C5) (the module
    docstring); ``in_channels``: C2-C5's widths, ResNet-50's by default."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 feature_size: int = 256):
        super().__init__()
        for level, c in enumerate(in_channels, start=2):
            self.add_module(f"lateral{level}", nn.Conv2d(c, feature_size, 1))
        for level in range(2, 6):
            self.add_module(f"output{level}",
                            nn.Conv2d(feature_size, feature_size, 3, padding=1))

    def forward(self, inputs) -> dict:
        laterals = [getattr(self, f"lateral{i + 2}")(c) for i, c in enumerate(inputs)]
        tds = [laterals[3]]
        for i in (2, 1, 0):
            tds.insert(0, laterals[i] + upsample_nearest(tds[0]))
        outs = {f"p{i + 2}": getattr(self, f"output{i + 2}")(t) for i, t in enumerate(tds)}
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs
