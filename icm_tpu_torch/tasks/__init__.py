"""Task networks of the ICM codecs: the ResNet backbones, RetinaNet's
pyramid and heads, its anchors and box utilities, the focal loss, and the
Detectron2-style P2-P6 pyramid of the R50-FPN task net. Port of
``icm_tpu/tasks`` (the MobileNetV2 and DeepLab parts come with a later
slice)."""

from .anchors import Anchors, bbox_transform, clip_boxes, nms_numpy
from .fpn import FPN, PyramidFeatures, upsample_nearest
from .losses import focal_loss
from .resnet import (BasicBlock, Bottleneck, FrozenBatchNorm2d, ResNetBackbone, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
from .retinanet import (ClassificationHead, RegressionHead, RetinaNet, decode_batch,
                        decode_detections)

__all__ = [
    "Anchors",
    "BasicBlock",
    "Bottleneck",
    "ClassificationHead",
    "FPN",
    "FrozenBatchNorm2d",
    "PyramidFeatures",
    "RegressionHead",
    "ResNetBackbone",
    "RetinaNet",
    "bbox_transform",
    "clip_boxes",
    "decode_batch",
    "decode_detections",
    "focal_loss",
    "nms_numpy",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "upsample_nearest",
]
