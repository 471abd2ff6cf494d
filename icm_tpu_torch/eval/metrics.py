"""Evaluation metrics.

Port of ``icm_tpu/eval/metrics.py``: ``psnr``, and the detection
evaluators as numpy on the host (the JAX package's own are numpy too; the
port keeps its own copy): ``compute_map``, a self-contained COCO-protocol
bbox evaluator (AP@[.5:.95] with the 101-point interpolation, AP50, AP75,
the area splits and AR@1/10/100), and ``csv_eval_ap``, the reference's
per-class AP at one IoU threshold (``retinanet/csv_eval.py``). MS-SSIM
and the segmentation metric come with later slices.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def psnr(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB of the mean squared error over all of a and b."""
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(max_val ** 2 / mse)


# --- COCO bbox mAP -----------------------------------------------------------

def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (N,4), b (M,4) xyxy -> (N,M)."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(br - tl, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


COCO_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _eval_class(
    detections,
    ground_truth,
    cls,
    iou_thresholds,
    max_dets,
    area_range,
):
    """Per-class COCO-protocol match: returns (scores (D,), tp (T, D) bool,
    ignored-det mask (T, D) bool, n_gt non-ignored). COCOeval ignore
    semantics (cocoeval.py evaluateImg): gts outside the area range are
    IGNORED — detections match non-ignored gts first (greedy by score,
    best IoU), may then absorb ignored gts, and such detections drop out
    of both TP and FP counts."""
    lo, hi = area_range
    T = len(iou_thresholds)
    all_scores, all_tp, all_ign = [], [[] for _ in range(T)], [
        [] for _ in range(T)
    ]
    n_gt = 0
    for iid, gt in ground_truth.items():
        g_mask = np.asarray(gt["labels"]) == cls
        g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[g_mask]
        g_area = np.clip(g_boxes[:, 2:] - g_boxes[:, :2], 0, None).prod(-1)
        g_ign = (g_area < lo) | (g_area >= hi)
        n_gt += int((~g_ign).sum())

        det = detections.get(iid)
        if det is None:
            continue
        d_mask = np.asarray(det["labels"]) == cls
        d_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)[d_mask]
        d_scores = np.asarray(det["scores"], np.float64)[d_mask]
        order = np.argsort(-d_scores, kind="mergesort")[:max_dets]
        d_boxes, d_scores = d_boxes[order], d_scores[order]
        all_scores.extend(d_scores)

        iou = (
            _box_iou(d_boxes, g_boxes)
            if len(g_boxes)
            else np.zeros((len(d_boxes), 0))
        )
        for ti, t in enumerate(iou_thresholds):
            taken = np.zeros(len(g_boxes), bool)
            for di in range(len(d_boxes)):
                best, bj = t - 1e-10, -1
                for gj in range(len(g_boxes)):
                    if taken[gj]:
                        continue
                    # once matched to a non-ignored gt, never downgrade
                    # to an ignored one (cocoeval.py: "if match made with
                    # an ignored gt, can be replaced by unignored")
                    if bj >= 0 and not g_ign[bj] and g_ign[gj]:
                        continue
                    if iou[di, gj] < best:
                        continue
                    best, bj = iou[di, gj], gj
                if bj >= 0:
                    taken[bj] = True
                    all_tp[ti].append(not g_ign[bj])
                    all_ign[ti].append(bool(g_ign[bj]))
                else:
                    all_tp[ti].append(False)
                    all_ign[ti].append(False)
    scores = np.asarray(all_scores)
    order = np.argsort(-scores, kind="mergesort")
    tp = np.asarray(all_tp, bool).reshape(T, -1)[:, order]
    ign = np.asarray(all_ign, bool).reshape(T, -1)[:, order]
    return scores[order], tp, ign, n_gt


def _ap_from_matches(tp, ign, n_gt, rec_thrs):
    """(T, D) matches -> (AP per threshold, max recall per threshold)."""
    T = tp.shape[0]
    aps, recs = np.zeros(T), np.zeros(T)
    for ti in range(T):
        keep = ~ign[ti]
        t = tp[ti][keep].astype(np.float64)
        tp_c = np.cumsum(t)
        fp_c = np.cumsum(1.0 - t)
        recall = tp_c / n_gt
        precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
        recs[ti] = recall[-1] if len(recall) else 0.0
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        if len(precision) == 0:
            continue
        idx = np.searchsorted(recall, rec_thrs, side="left")
        prec_at = np.where(
            idx < len(precision),
            precision[np.minimum(idx, len(precision) - 1)],
            0.0,
        )
        aps[ti] = prec_at.mean()
    return aps, recs


def compute_map(
    detections: Dict[int, Dict],
    ground_truth: Dict[int, Dict],
    iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
    max_dets: int = 100,
    class_names: Optional[Dict[int, str]] = None,
) -> Dict[str, object]:
    """Full COCO-protocol bbox metric surface.

    detections[image_id] = {"boxes" (N,4) xyxy, "scores" (N,), "labels" (N,)}
    ground_truth[image_id] = {"boxes" (G,4) xyxy, "labels" (G,)}

    Returns the COCOeval summary set (reference analogs:
    ``retinanet/coco_eval.py:1-84`` COCOeval summarize, and per-class AP
    as in ``retinanet/csv_eval.py:1-259``):
      mAP, AP50, AP75                      (IoU .50:.95 / .50 / .75)
      AP_small, AP_medium, AP_large        (gt area ranges, COCO splits)
      AR1, AR10, AR100                     (max recall @ 1/10/100 dets)
      AR_small, AR_medium, AR_large        (AR@100 per area range)
      per_class_AP: {class or name: AP}    (IoU .50:.95, area all)
    averaged over classes present in the ground truth.
    """
    classes = sorted(
        {int(l) for g in ground_truth.values() for l in np.asarray(g["labels"])}
    )
    rec_thrs = np.linspace(0, 1, 101)

    def summarize(area, mdets):
        ap_list, ar_list, per_class = [], [], {}
        for c in classes:
            scores, tp, ign, n_gt = _eval_class(
                detections, ground_truth, c, iou_thresholds, mdets,
                COCO_AREA_RANGES[area],
            )
            if n_gt == 0:
                continue
            aps, recs = _ap_from_matches(tp, ign, n_gt, rec_thrs)
            ap_list.append(aps)
            ar_list.append(recs.mean())
            per_class[c] = float(aps.mean())
        if not ap_list:
            return None
        ap_by_t = np.stack(ap_list).mean(axis=0)
        return {
            "ap": float(ap_by_t.mean()),
            "ap50": float(ap_by_t[0]),
            "ap75": float(ap_by_t[5]) if len(ap_by_t) > 5 else float(
                ap_by_t[-1]
            ),
            "ar": float(np.mean(ar_list)),
            "per_class": per_class,
        }

    base = summarize("all", max_dets)
    if base is None:
        zeros = {
            k: 0.0
            for k in (
                "mAP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
                "AR1", "AR10", "AR100", "AR_small", "AR_medium", "AR_large",
            )
        }
        zeros["per_class_AP"] = {}
        return zeros

    def name(c):
        return class_names.get(c, c) if class_names else c

    out = {
        "mAP": base["ap"],
        "AP50": base["ap50"],
        "AP75": base["ap75"],
        "AR100": base["ar"],
        "per_class_AP": {name(c): v for c, v in base["per_class"].items()},
    }
    for tag, mdets in (("AR1", 1), ("AR10", 10)):
        r = summarize("all", mdets)
        out[tag] = r["ar"] if r else 0.0
    # COCOeval reports -1 for an area range with no ground truth
    for area in ("small", "medium", "large"):
        r = summarize(area, max_dets)
        out[f"AP_{area}"] = r["ap"] if r else -1.0
        out[f"AR_{area}"] = r["ar"] if r else -1.0
    return out


def _ap_envelope(recall: np.ndarray, precision: np.ndarray) -> float:
    """py-faster-rcnn AP: monotone precision envelope integrated over the
    recall steps (reference ``retinanet/csv_eval.py:38-63`` _compute_ap)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def csv_eval_ap(
    dets: dict,
    gts: dict,
    num_classes: int,
    iou_threshold: float = 0.5,
    score_threshold: float = 0.05,
    max_detections: int = 100,
):
    """Per-class AP at a single IoU threshold — the reference's standalone
    CSV detection-eval protocol (``retinanet/csv_eval.py:152-259``): per
    image keep the top-``max_detections`` above ``score_threshold``, match
    greedily in descending-score order against same-class GT (one GT, one
    match), then sort all detections globally by score and integrate the
    py-faster-rcnn precision envelope.

    dets/gts: {image_key: {"boxes" (N,4) xyxy, "scores"?, "labels"}}.
    Returns {label_id: (ap, num_annotations)} — num_annotations == 0 maps to
    (0, 0) like the reference.
    """
    out = {}
    keys = sorted(gts.keys(), key=str)
    for label in range(num_classes):
        fps, tps, scores = [], [], []
        num_annotations = 0
        for k in keys:
            g = gts[k]
            ann = np.asarray(g["boxes"], np.float64).reshape(-1, 4)[
                np.asarray(g["labels"]).reshape(-1) == label
            ]
            num_annotations += ann.shape[0]
            d = dets.get(k)
            if d is None:
                continue
            ds = np.asarray(d["scores"], np.float64).reshape(-1)
            db = np.asarray(d["boxes"], np.float64).reshape(-1, 4)
            dl = np.asarray(d["labels"]).reshape(-1)
            keep = ds > score_threshold
            order = np.argsort(-ds[keep])[:max_detections]
            db, ds, dl = db[keep][order], ds[keep][order], dl[keep][order]
            cls_mask = dl == label
            matched = set()
            for box, score in zip(db[cls_mask], ds[cls_mask]):
                scores.append(score)
                if ann.shape[0] == 0:
                    fps.append(1.0)
                    tps.append(0.0)
                    continue
                overlaps = _box_iou(box[None], ann)[0]
                j = int(np.argmax(overlaps))
                if overlaps[j] >= iou_threshold and j not in matched:
                    fps.append(0.0)
                    tps.append(1.0)
                    matched.add(j)
                else:
                    fps.append(1.0)
                    tps.append(0.0)
        if num_annotations == 0:
            out[label] = (0.0, 0)
            continue
        order = np.argsort(-np.asarray(scores))
        fp = np.cumsum(np.asarray(fps)[order])
        tp = np.cumsum(np.asarray(tps)[order])
        recall = tp / num_annotations
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        out[label] = (_ap_envelope(recall, precision), int(num_annotations))
    return out
