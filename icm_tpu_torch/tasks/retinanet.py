"""RetinaNet detector.

Port of ``icm_tpu/tasks/retinanet.py``: a ResNet backbone, the P3-P7
pyramid, a regression head (4 x conv 256 + ReLU, then 4 values an
anchor) and a classification head (the same, then K sigmoid scores an
anchor, the output bias at the focal-loss prior), shared over the
levels. ``RetinaNet.forward`` takes NHWC images and returns the
reference's 5-tuple ``(compressH, [C3, C4, C5], classification,
regression, anchors)``, the features NHWC as the JAX package's.

The heads compute in NCHW; their maps are laid out NHWC before the
reshape to ``(B, -1, 4 | K)``, so that the rows run over (level, y, x,
anchor) as the anchors do (``anchors.Anchors``). The anchors are built on
the host once for each image shape and kept on the model's device.

The network runs in the dtype its input promotes to with its float32
parameters (the JAX package's ``tasks`` take no activation dtype, and
flax promotes a bfloat16 input with float32 kernels to float32): under
the bfloat16 policy it runs on a bfloat16 ``x_hat`` in float32.

``decode_detections`` (host-side NMS per class) is the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .anchors import Anchors, bbox_transform, clip_boxes, nms_numpy
from .fpn import PyramidFeatures
from .resnet import ResNetBackbone


class _Head(nn.Module):
    """conv1-conv4 (3x3, ReLU) and a 3x3 ``output`` of ``out_per_anchor``
    values for each of ``num_anchors`` anchors, laid out ``(B, -1,
    out_per_anchor)`` in NHWC order."""

    def __init__(self, out_per_anchor: int, num_anchors: int = 9, feature_size: int = 256,
                 in_channels: int = 256):
        super().__init__()
        self.out_per_anchor = out_per_anchor
        for i in range(4):
            self.add_module(f"conv{i + 1}", nn.Conv2d(in_channels if i == 0 else feature_size,
                                                      feature_size, 3, padding=1))
        self.output = nn.Conv2d(feature_size, num_anchors * out_per_anchor, 3, padding=1)

    def _maps(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        return self.output(x)

    def _rows(self, x):
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.out_per_anchor)


class RegressionHead(_Head):
    def __init__(self, num_anchors: int = 9, feature_size: int = 256, in_channels: int = 256):
        super().__init__(4, num_anchors, feature_size, in_channels)

    def forward(self, x):
        return self._rows(self._maps(x))


class ClassificationHead(_Head):
    def __init__(self, num_classes: int, num_anchors: int = 9, feature_size: int = 256,
                 prior: float = 0.01, in_channels: int = 256):
        super().__init__(num_classes, num_anchors, feature_size, in_channels)
        # read by models.init_parameters: flax's constant bias init
        self.output.bias_init = float(-math.log((1.0 - prior) / prior))

    def forward(self, x):
        return self._rows(torch.sigmoid(self._maps(x)))


class RetinaNet(nn.Module):
    def __init__(self, num_classes: int = 80, block: str = "bottleneck",
                 layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = ResNetBackbone(block=block, layers=layers)
        widths = [w * (4 if block == "bottleneck" else 1) for w in (128, 256, 512)]
        self.fpn = PyramidFeatures(widths)
        self.regression = RegressionHead()
        self.classification = ClassificationHead(num_classes)
        self._anchor_maker = Anchors()
        self._anchor_cache: Dict[tuple, torch.Tensor] = {}

    def anchors(self, image_hw, device) -> torch.Tensor:
        """(1, A, 4) float32 anchors of an (H, W) image on ``device``,
        built on the host at the first call for that shape."""
        key = (int(image_hw[0]), int(image_hw[1]), torch.device(device))
        if key not in self._anchor_cache:
            self._anchor_cache[key] = torch.from_numpy(self._anchor_maker(key[:2])).to(device)
        return self._anchor_cache[key]

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 3) -> ``(compressH, [C3, C4, C5], classification
        (B, A, K), regression (B, A, 4), anchors (1, A, 4))``."""
        w = self.backbone.Conv_0.weight
        h = x.permute(0, 3, 1, 2).to(torch.promote_types(x.dtype, w.dtype))
        c2, c3, c4, c5 = self.backbone(h)
        features = self.fpn([c3, c4, c5])
        regression = torch.cat([self.regression(f) for f in features], dim=1)
        classification = torch.cat([self.classification(f) for f in features], dim=1)
        anchors = self.anchors(x.shape[1:3], x.device)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return nhwc(c2), [nhwc(c) for c in (c3, c4, c5)], classification, regression, anchors


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def decode_detections(classification, regression, anchors, image_shape_hw,
                      score_thresh: float = 0.05, iou_thresh: float = 0.5):
    """Host-side decode of the first image of a batch: boxes from the
    anchors and deltas, clipped, then per class the scores above
    ``score_thresh`` through greedy NMS. -> (scores, labels, boxes) numpy
    arrays. Tensors on the card are copied to the host."""
    cls = _host(classification)[0]  # (A, K)
    reg = _host(regression)[0]
    anc = _host(anchors)[0]
    boxes_all = clip_boxes(bbox_transform(anc, reg), image_shape_hw)

    scores_out, labels_out, boxes_out = [], [], []
    for k in range(cls.shape[1]):
        scores = cls[:, k]
        mask = scores > score_thresh
        if not mask.any():
            continue
        keep = nms_numpy(boxes_all[mask], scores[mask], iou_thresh)
        scores_out.append(scores[mask][keep])
        labels_out.append(np.full(keep.shape[0], k, np.int64))
        boxes_out.append(boxes_all[mask][keep])
    if not scores_out:
        return (np.zeros((0,), np.float32), np.zeros((0,), np.int64),
                np.zeros((0, 4), np.float32))
    return np.concatenate(scores_out), np.concatenate(labels_out), np.concatenate(boxes_out)


def decode_batch(classification, regression, anchors, image_shape_hw,
                 score_thresh: float = 0.05, iou_thresh: float = 0.5) -> list:
    """:func:`decode_detections` for every image of a batch, the maps
    copied to the host once: -> [(scores, labels, boxes)] an image."""
    cls, reg, anc = _host(classification), _host(regression), _host(anchors)
    return [decode_detections(cls[b:b + 1], reg[b:b + 1], anc, image_shape_hw, score_thresh,
                              iou_thresh) for b in range(cls.shape[0])]
