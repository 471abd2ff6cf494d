"""ICM codecs with task networks: ``oj_ICM``, ``seg_oj_ICM`` and ``cnn2``.

Port of ``icm_tpu/models/icm.py``'s ``FasterRCNN_Coding``,
``MaskedRCNN_FasterRCNN_Coding`` (with ``_FrozenFPN``) and ``WACNN2``.

``oj_ICM`` (:class:`FasterRCNN_Coding`) is a codec trained by feature
distillation: ``MainCNNEncoder`` to y (M channels at /16), the zigzag
ChARM coder (``zigzag_coder.ZigzagCharmCoder``: ``num_slices`` x 2x2
zigzag blocks, 8 slices of M / 2 channels at the defaults, sliding
support 4, a conditioning window of 8 blocks, 3-conv context stacks, LRP
applied) and ``MainCNNDecoder`` to x_hat; a frozen R50-FPN task net
(:class:`_FrozenFPN`: ``tasks.resnet.ResNetBackbone`` and ``tasks.fpn.FPN``,
P2-P6 at 256 channels) runs on x (the teacher, under ``no_grad``) and on
x_hat (the student, with gradients to x_hat). The forward returns the JAX
package's dict: ``x_hat`` and ``decompressedImage`` (one tensor),
``likelihoods`` ({"y", "z"}), ``Student_output_features`` and
``Teacher_output_features`` ({"p2" ... "p6"} or None without the task
net), NHWC. It carries the ChARM protocol (``analyze``, ``synthesize``,
``ctx_prepare``, ``latent_slices``, ``ctx_slices``, ``ctx_support``,
``slice_context``, ``slice_lrp``, ``ctx_assemble``, ``eb_medians``) by
delegating to its coder, as JAX's does, so ``codec.CharmCodec`` and
``device_codec.DeviceWireCodec`` serve it; no scan wire drives it (JAX's
``DeviceWireCodec`` serves its unrolled device wire when asked for one; the
port's raises).

``seg_oj_ICM`` (:class:`MaskedRCNN_FasterRCNN_Coding`) adds a second coding
layer: ``seg_g_a`` (a ``MainCNNEncoder`` of 6 channels) analyses
``cat(x_hat, x)``, a second zigzag coder codes its latent and
``seg_x_hat = seg_g_s(seg_y_hat) + x_hat``. Its dict: ``x_hat`` and
``decompressedImage`` (seg_x_hat), ``machine_x_hat``, ``likelihoods`` (the
segmentation layer's), ``machine_likelihoods``, and the features, the
student's on the machine layer's x_hat. ``crc_codec.SegOjCodec`` serves
it; its bottlenecks are keyed ``entropy_bottleneck`` and
``seg_entropy_bottleneck``, as JAX's ``eb_dict`` keys them.

Train both with ``train.DetectionICMLoss`` through ``run_training(...,
freeze_patterns=("task_net",))`` (``seg_oj_ICM``: and
``train_patterns=("seg",)``, so its feature term reaches no trainable
parameter, as in JAX). The task net runs in float32 under the bfloat16
policy (JAX's ``tasks/`` read no policy); its BatchNorm is
``FrozenBatchNorm2d``. Its parameters are drawn after the codec's.

``cnn2`` (:class:`WACNN2`): WACNN (``cnn.WACNN``) with a RetinaNet student
(``tasks.retinanet.RetinaNet``, ResNet-50, P3-P7, 9 anchors x
``num_classes``) run on the reconstruction ``x_hat``. The forward returns
the JAX package's dict: ``x_hat`` and ``likelihoods`` as WACNN's, the
student's stage C2 as ``decompressH``, [C3, C4, C5] as
``Student_output_features``, and its ``Student_classification``,
``Student_regression`` and ``Student_anchors``; ``compressH`` and
``Teacher_output_features`` are None. ``with_task_net=False`` leaves the
student out.

``cnn2``'s codec is WACNN's, and the coders (``CharmCodec``,
``DeviceWireCodec`` and its scan wire) serve it as they serve ``cnn``: the
student does not enter the wires. :func:`decompress_detect` is the serving
call that detects on the decoded image (the JAX package's bitstream-level
detection loop, ``tools/eval_model.py``).

No loss of the training package reads ``cnn2``'s student outputs, so its
parameters get no gradient in a training step (JAX's are zeros) and its
BatchNorm statistics never move. The eager forward still runs it, where
XLA drops it from JAX's jitted step. The student's parameters are drawn
after the codec's, so a ``cnn2`` and a ``cnn`` built from one seed have
the same codec weights.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..nn.factories import main_cnn_decoder, main_cnn_encoder
from ..tasks.fpn import FPN
from ..tasks.resnet import ResNetBackbone
from ..tasks.retinanet import RetinaNet, decode_batch
from .base import CompressionModel, nchw_to_nhwc, nhwc_to_nchw
from .cnn import WACNN
from .zigzag_coder import ZigzagCharmCoder


class _FrozenFPN(nn.Module):
    """The R50-FPN feature extractor (the reference's Detectron2 bridge):
    ``ResNetBackbone`` (its BatchNorm frozen) then ``FPN``, under the flax
    names ``ResNetBackbone_0`` and ``FPN_0``. NCHW images in, the P2-P6
    dict out (NCHW), float32 whatever the input's dtype."""

    def __init__(self, block: str = "bottleneck", layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.ResNetBackbone_0 = ResNetBackbone(block=block, layers=layers)
        widths = [w * (4 if block == "bottleneck" else 1) for w in (64, 128, 256, 512)]
        self.FPN_0 = FPN(widths)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        w = self.ResNetBackbone_0.Conv_0.weight
        return self.FPN_0(self.ResNetBackbone_0(x.to(torch.promote_types(x.dtype, w.dtype))))


def _nhwc_features(feats):
    """A P2-P6 dict in the JAX layout (NHWC views), or None."""
    return None if feats is None else {k: v.permute(0, 2, 3, 1) for k, v in feats.items()}


class _DetectionCoding(CompressionModel):
    """What ``oj_ICM`` and ``seg_oj_ICM`` share: the machine layer (``g_a``,
    ``g_s``, ``coder``), a second layer's modules where a subclass builds
    them (:meth:`_second_layer`), then the frozen task net."""

    def __init__(
        self,
        N: int = 192,
        M: int = 384,
        num_slices: int = 2,
        max_support: int = 4,
        support_num: int = 8,
        mid: int = 256,
        hyper_enc_widths: Tuple[int, ...] = (384, 336, 288, 240, 192),
        hyper_dec_widths: Tuple[int, ...] = (240, 288, 336, 384, 384),
        cc_widths: Tuple[int, ...] = (224, 64),
        with_task_net: bool = True,
        task_layers: Tuple[int, ...] = (3, 4, 6, 3),
    ):
        super().__init__()
        self.N, self.M, self.mid = N, M, mid
        self.num_slices, self.max_support, self.support_num = num_slices, max_support, support_num
        self.with_task_net = with_task_net
        coder = dict(latent_dim=M, num_slices=num_slices, max_support=max_support,
                     support_num=support_num, hyper_enc_widths=tuple(hyper_enc_widths),
                     hyper_dec_widths=tuple(hyper_dec_widths), cc_widths=tuple(cc_widths),
                     apply_lrp=True)
        self.g_a = main_cnn_encoder(N, M)
        self.g_s = main_cnn_decoder(N, M, mid)
        self.coder = ZigzagCharmCoder(**coder)
        self._second_layer(coder)
        if with_task_net:
            self.task_net = _FrozenFPN(layers=tuple(task_layers))

    def _second_layer(self, coder: dict) -> None:
        pass

    def _features(self, x, x_hat):
        """-> (the teacher's features of x, under no_grad; the student's of
        x_hat), NCHW, or (None, None) without the task net."""
        if not self.with_task_net:
            return None, None
        with torch.no_grad():
            teacher = self.task_net(x)
        return teacher, self.task_net(x_hat)


class FasterRCNN_Coding(_DetectionCoding):
    """oj_ICM (registry "oj_ICM"): the module docstring's."""

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """x: (B, H, W, 3) -> the output dict (module docstring), NHWC; noise
        drawn from ``generator`` (training), rounding without (eval)."""
        x = nhwc_to_nchw(x)
        y_hat, likelihoods = self.coder.code(self.g_a(x), generator)
        x_hat = self.g_s(y_hat)
        teacher, student = self._features(x, x_hat)
        x_hat = nchw_to_nhwc(x_hat)
        return {"x_hat": x_hat, "decompressedImage": x_hat, "likelihoods": likelihoods,
                "Student_output_features": _nhwc_features(student),
                "Teacher_output_features": _nhwc_features(teacher)}

    def aux_loss(self) -> torch.Tensor:
        return self.coder.entropy_bottleneck.aux_loss()

    def eb_dict(self) -> dict:
        return {"entropy_bottleneck": self.coder.entropy_bottleneck}

    # --- the ChARM protocol, delegated to the coder (CharmCodec codes the
    # machine bitstream; the task net is not on the wire) ---------------------
    def analyze(self, x):
        y = self.g_a(x)
        return y, self.coder.h_a(y)

    def synthesize(self, y_hat):
        return self.g_s(y_hat)

    def ctx_prepare(self, z_hat):
        return self.coder.ctx_prepare(z_hat)

    def latent_slices(self, y):
        return self.coder.latent_slices(y)

    @property
    def ctx_slices(self) -> int:
        return self.coder.ctx_slices

    def ctx_support(self, i: int, decoded: list) -> list:
        return self.coder.ctx_support(i, decoded)

    def slice_context(self, i, state, support):
        return self.coder.slice_context(i, state, support)

    def slice_lrp(self, i, mean_support, y_hat_slice):
        return self.coder.slice_lrp(i, mean_support, y_hat_slice)

    def ctx_assemble(self, y_hat_slices):
        return self.coder.ctx_assemble(y_hat_slices)

    def eb_medians(self) -> torch.Tensor:
        return self.coder.eb_medians()


class MaskedRCNN_FasterRCNN_Coding(_DetectionCoding):
    """seg_oj_ICM (registry "seg_oj_ICM"): the module docstring's. The
    stages ``crc_codec.SegOjCodec`` calls: ``g_a``, the coders' protocol,
    :meth:`machine_synthesize`, :meth:`seg_analyze`, :meth:`seg_synthesize`."""

    def _second_layer(self, coder: dict) -> None:
        self.seg_g_a = main_cnn_encoder(self.N, self.M, in_ch=6)
        self.seg_g_s = main_cnn_decoder(self.N, self.M, self.mid)
        self.seg_coder = ZigzagCharmCoder(**coder)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """x: (B, H, W, 3) -> the output dict (module docstring), NHWC; noise
        drawn from ``generator`` (training), rounding without (eval), the
        machine layer's before the segmentation layer's."""
        x = nhwc_to_nchw(x)
        y_hat, m_lik = self.coder.code(self.g_a(x), generator)
        x_hat = self.machine_synthesize(y_hat)
        teacher, student = self._features(x, x_hat)
        seg_y_hat, seg_lik = self.seg_coder.code(self.seg_analyze(x, x_hat), generator)
        seg_x_hat = nchw_to_nhwc(self.seg_synthesize(seg_y_hat, x_hat))
        return {"x_hat": seg_x_hat, "decompressedImage": seg_x_hat,
                "machine_x_hat": nchw_to_nhwc(x_hat), "likelihoods": seg_lik,
                "machine_likelihoods": m_lik,
                "Student_output_features": _nhwc_features(student),
                "Teacher_output_features": _nhwc_features(teacher)}

    # --- coder-facing stages (crc_codec.SegOjCodec) ------------------------------
    def machine_synthesize(self, y_hat):
        return self.g_s(y_hat)

    def seg_analyze(self, x, x_hat):
        """The segmentation latent from the images and the machine layer's
        reconstruction (NCHW; x_hat first, as JAX concatenates them)."""
        return self.seg_g_a(torch.cat([x_hat, x], dim=1))

    def seg_synthesize(self, seg_y_hat, x_hat):
        return self.seg_g_s(seg_y_hat) + x_hat

    def aux_loss(self) -> torch.Tensor:
        return (self.coder.entropy_bottleneck.aux_loss()
                + self.seg_coder.entropy_bottleneck.aux_loss())

    def eb_dict(self) -> dict:
        return {"entropy_bottleneck": self.coder.entropy_bottleneck,
                "seg_entropy_bottleneck": self.seg_coder.entropy_bottleneck}


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
