"""Detection focal loss.

Port of ``icm_tpu/tasks/losses.py::focal_loss``: anchors matched to the
ground truth by IoU (positive at 0.5 or more, ignored between 0.4 and
0.5), alpha 0.25 / gamma 2 focal BCE on the classification scores, and
the smooth-L1-like regression loss (beta 1/9) on the positives against
targets normalized by (0.1, 0.1, 0.2, 0.2). The ground truth is padded to
a fixed number of boxes a batch, padding rows labelled -1, and the loss
is computed for all images at once; each image's terms are averaged over
the batch, as JAX's ``vmap`` and mean do.
"""

from __future__ import annotations

import torch


def _iou_matrix(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """anchors (A, 4), boxes (B, G, 4) -> (B, A, G) IoU."""
    a = anchors[None, :, None, :]  # (1, A, 1, 4)
    b = boxes[:, None, :, :]  # (B, 1, G, 4)
    inter_w = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]),
                          min=0)
    inter_h = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]),
                          min=0)
    inter = inter_w * inter_h
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-8)


def focal_loss(classifications: torch.Tensor, regressions: torch.Tensor, anchors: torch.Tensor,
               annotations: torch.Tensor, alpha: float = 0.25, gamma: float = 2.0):
    """classifications (B, A, K) after the sigmoid; regressions (B, A, 4);
    anchors (A, 4); annotations (B, G, 5) rows [x1, y1, x2, y2, label],
    label -1 for padding. -> (cls_loss, reg_loss), 0-d tensors."""
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    ctr_x = anchors[:, 0] + 0.5 * widths
    ctr_y = anchors[:, 1] + 0.5 * heights

    valid = annotations[..., 4] >= 0  # (B, G)
    has_gt = valid.any(dim=1)[:, None]  # (B, 1)
    boxes = annotations[..., :4]
    iou = torch.where(valid[:, None, :], _iou_matrix(anchors, boxes), -1.0)
    iou_max, iou_arg = iou.max(dim=2)  # (B, A): the first of equal maxima

    cls = torch.clamp(classifications, 1e-4, 1.0 - 1e-4)
    K = cls.shape[-1]
    label = torch.gather(annotations[..., 4], 1, iou_arg).to(torch.int64)  # (B, A)
    # one-hot as jax.nn.one_hot: a label outside [0, K) gives a zero row
    one_hot = (label[..., None] == torch.arange(K, device=label.device)).to(cls.dtype)
    positive = iou_max >= 0.5
    targets = one_hot * positive[..., None].to(cls.dtype)
    ignore = (iou_max >= 0.4) & (iou_max < 0.5)

    is_target = targets == 1.0
    alpha_factor = torch.where(is_target, alpha, 1.0 - alpha)
    focal_weight = torch.where(is_target, 1.0 - cls, cls) ** gamma
    bce = -(targets * torch.log(cls) + (1.0 - targets) * torch.log(1.0 - cls))
    cls_loss = torch.where(ignore[..., None], 0.0, alpha_factor * focal_weight * bce)
    pos = positive & has_gt  # (B, A)
    num_pos = torch.clamp(pos.sum(dim=1).to(cls.dtype), min=1.0)
    cls_total = cls_loss.sum(dim=(1, 2)) / num_pos

    gt = torch.gather(boxes, 1, iou_arg[..., None].expand(-1, -1, 4))  # (B, A, 4)
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1.0)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1.0)
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    t = torch.stack([(gx - ctr_x) / widths / 0.1, (gy - ctr_y) / heights / 0.1,
                     torch.log(gw / widths) / 0.2, torch.log(gh / heights) / 0.2], dim=-1)
    diff = torch.abs(t - regressions)
    reg_loss = torch.where(diff <= 1.0 / 9.0, 0.5 * 9.0 * diff ** 2, diff - 0.5 / 9.0)
    reg_total = (torch.where(pos[..., None], reg_loss, 0.0).sum(dim=(1, 2))
                 / torch.clamp(pos.sum(dim=1).to(cls.dtype) * 4, min=1.0))
    return cls_total.mean(), reg_total.mean()
