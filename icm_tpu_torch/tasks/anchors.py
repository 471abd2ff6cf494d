"""Anchor generation and box utilities for RetinaNet (numpy, on the host).

The port's own copy of ``icm_tpu/tasks/anchors.py``: pyramid levels 3-7,
strides 2^l, base sizes 2^(l+2), ratios (0.5, 1, 2), scales (1, 2^(1/3),
2^(2/3)); the regression deltas' transform with mean 0 and std (0.1,
0.1, 0.2, 0.2); clipping to the image; greedy IoU NMS. Detection
post-processing is sequential and small, so it stays on the host.
"""

from __future__ import annotations

import numpy as np


class Anchors:
    def __init__(
        self,
        pyramid_levels=(3, 4, 5, 6, 7),
        ratios=(0.5, 1.0, 2.0),
        scales=(2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)),
    ):
        self.pyramid_levels = list(pyramid_levels)
        self.strides = [2 ** x for x in self.pyramid_levels]
        self.sizes = [2 ** (x + 2) for x in self.pyramid_levels]
        self.ratios = np.array(ratios)
        self.scales = np.array(scales)

    def _base_anchors(self, base_size: float) -> np.ndarray:
        num = len(self.ratios) * len(self.scales)
        anchors = np.zeros((num, 4))
        anchors[:, 2:] = base_size * np.tile(self.scales, (2, len(self.ratios))).T
        areas = anchors[:, 2] * anchors[:, 3]
        anchors[:, 2] = np.sqrt(areas / np.repeat(self.ratios, len(self.scales)))
        anchors[:, 3] = anchors[:, 2] * np.repeat(self.ratios, len(self.scales))
        anchors[:, 0::2] -= np.tile(anchors[:, 2] * 0.5, (2, 1)).T
        anchors[:, 1::2] -= np.tile(anchors[:, 3] * 0.5, (2, 1)).T
        return anchors

    def __call__(self, image_shape_hw) -> np.ndarray:
        """(H, W) -> (1, total_anchors, 4) float32 in x1, y1, x2, y2; per
        level the cells in row-major order, 9 anchors a cell."""
        image_shape = np.array(image_shape_hw)
        shapes = [(image_shape + 2 ** x - 1) // (2 ** x) for x in self.pyramid_levels]
        all_anchors = np.zeros((0, 4), np.float32)
        for idx in range(len(self.pyramid_levels)):
            base = self._base_anchors(self.sizes[idx])
            stride = self.strides[idx]
            sh = shapes[idx]
            sx = (np.arange(0, sh[1]) + 0.5) * stride
            sy = (np.arange(0, sh[0]) + 0.5) * stride
            sx, sy = np.meshgrid(sx, sy)
            shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
            A, K = base.shape[0], shifts.shape[0]
            lvl = (base[None] + shifts[:, None]).reshape(K * A, 4)
            all_anchors = np.concatenate([all_anchors, lvl.astype(np.float32)])
        return all_anchors[None]


def bbox_transform(anchors, deltas, mean=(0, 0, 0, 0), std=(0.1, 0.1, 0.2, 0.2)):
    """Apply regression deltas (dx, dy, dw, dh) to anchors (x1, y1, x2, y2)."""
    mean = np.asarray(mean)
    std = np.asarray(std)
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights

    dx = deltas[..., 0] * std[0] + mean[0]
    dy = deltas[..., 1] * std[1] + mean[1]
    dw = deltas[..., 2] * std[2] + mean[2]
    dh = deltas[..., 3] * std[3] + mean[3]

    pred_ctr_x = ctr_x + dx * widths
    pred_ctr_y = ctr_y + dy * heights
    pred_w = np.exp(dw) * widths
    pred_h = np.exp(dh) * heights

    return np.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                     pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], axis=-1)


def clip_boxes(boxes, image_shape_hw):
    H, W = image_shape_hw
    out = boxes.copy()
    out[..., 0] = np.clip(out[..., 0], 0, W)
    out[..., 1] = np.clip(out[..., 1], 0, H)
    out[..., 2] = np.clip(out[..., 2], 0, W)
    out[..., 3] = np.clip(out[..., 3], 0, H)
    return out


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5):
    """Greedy NMS; returns the kept indices, best score first."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-8)
        order = order[1:][iou <= iou_threshold]
    return np.asarray(keep, np.int64)
