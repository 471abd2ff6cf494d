"""Task networks of the ICM codecs: the ResNet backbones, RetinaNet's
pyramid and heads, its anchors and box utilities, and the focal loss.
Port of ``icm_tpu/tasks`` (the MobileNetV2, DeepLab and Detectron2-style
FPN parts come with later slices)."""

from .anchors import Anchors, bbox_transform, clip_boxes, nms_numpy
from .fpn import PyramidFeatures, upsample_nearest
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
