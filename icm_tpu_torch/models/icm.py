"""ICM codecs with task networks: ``cnn2`` (registry "cnn2").

Port of ``icm_tpu/models/icm.py::WACNN2``: WACNN (``cnn.WACNN``) with a
RetinaNet student (``tasks.retinanet.RetinaNet``, ResNet-50, P3-P7, 9
anchors x ``num_classes``) run on the reconstruction ``x_hat``. The
forward returns the JAX package's dict: ``x_hat`` and ``likelihoods`` as
WACNN's, the student's stage C2 as ``decompressH``, [C3, C4, C5] as
``Student_output_features``, and its ``Student_classification``,
``Student_regression`` and ``Student_anchors``; ``compressH`` and
``Teacher_output_features`` are None. ``with_task_net=False`` leaves the
student out.

The codec is WACNN's, and the coders (``CharmCodec``, ``DeviceWireCodec``
and its scan wire) serve it as they serve ``cnn``: the student does not
enter the wires. :func:`decompress_detect` is the serving call that
detects on the decoded image (the JAX package's bitstream-level
detection loop, ``tools/eval_model.py``).

No loss of the training package reads the student's outputs, so its
parameters get no gradient in a training step (JAX's are zeros) and its
BatchNorm statistics never move. The eager forward still runs it, where
XLA drops it from JAX's jitted step. The student's parameters are drawn
after the codec's, so a ``cnn2`` and a ``cnn`` built from one seed have
the same codec weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..tasks.retinanet import RetinaNet, decode_batch
from .cnn import WACNN


class WACNN2(WACNN):
    """cnn2: WACNN + a RetinaNet student on the reconstruction."""

    def __init__(self, with_task_net: bool = True, num_classes: int = 80,
                 task_block: str = "bottleneck", task_layers: Tuple[int, ...] = (3, 4, 6, 3),
                 **codec):
        super().__init__(**codec)
        self.with_task_net = with_task_net
        if with_task_net:
            self.studentNet = RetinaNet(num_classes=num_classes, block=task_block,
                                        layers=task_layers)

    def forward(self, x: torch.Tensor, generator=None) -> dict:
        out = super().forward(x, generator)
        result: Dict[str, Any] = {
            "compressH": None,
            "decompressH": None,
            "x_hat": out["x_hat"],
            "likelihoods": out["likelihoods"],
            "Student_output_features": None,
            "Teacher_output_features": None,
            "Student_classification": None,
            "Student_regression": None,
            "Student_anchors": None,
        }
        if self.with_task_net:
            compressH, feats, cls, reg, anchors = self.studentNet(out["x_hat"])
            result.update(decompressH=compressH, Student_output_features=feats,
                          Student_classification=cls, Student_regression=reg,
                          Student_anchors=anchors)
        return result


@torch.no_grad()
def decompress_detect(codec, strings, shape, image_hw: Optional[Tuple[int, int]] = None,
                      score_thresh: float = 0.05, iou_thresh: float = 0.5) -> Dict[str, Any]:
    """Decode a ``cnn2`` bitstream and detect on the decoded images: the
    codec's ``decompress`` (any wire), the student on ``x_hat`` on the
    codec's device, then the host-side NMS decode of each image
    (``tasks.retinanet.decode_detections``: the classification and
    regression maps are copied to the host once, as the JAX loop copies
    them). ``image_hw``: the image's own size inside a padded ``x_hat``,
    for clipping the boxes (default: ``x_hat``'s).

    -> {"x_hat", "y_hat" (the codec's), "classification", "regression",
    "anchors" (the student's, on the device), "detections": a (scores,
    labels, boxes) tuple of numpy arrays an image}."""
    student = getattr(codec.model, "studentNet", None)
    if student is None:
        raise ValueError(f"{type(codec.model).__name__} carries no detector (studentNet); "
                         "decompress_detect serves cnn2 built with with_task_net=True")
    dec = codec.decompress(strings, shape)
    x_hat = dec["x_hat"]
    _, _, cls, reg, anchors = student(x_hat)
    hw = tuple(image_hw) if image_hw is not None else tuple(x_hat.shape[1:3])
    return {**dec, "classification": cls, "regression": reg, "anchors": anchors,
            "detections": decode_batch(cls, reg, anchors, hw, score_thresh, iou_thresh)}
