"""MOS classification metrics and detection recall (port of
insmos_tpu/train/metrics.py): the confusion matrix (rows predicted,
columns ground truth), IoU with the ignored class's column zeroed, and
recall at IoU thresholds against the ground-truth boxes."""

from __future__ import annotations

import torch

from ..constants import IGNORE_INDEX, N_MOS_CLASSES
from ..ops.iou3d import boxes_iou3d


def confusion_matrix(pred_logits, gt_labels, valid,
                     n_classes: int = N_MOS_CLASSES):
    """Argmax with ignored logits at -inf, then counts of (pred, gt)."""
    ignore = torch.zeros(n_classes, dtype=torch.bool,
                         device=pred_logits.device)
    ignore[list(IGNORE_INDEX)] = True
    pred = torch.where(ignore[None, :], float("-inf"),
                       pred_logits).argmax(dim=-1)
    flat = pred * n_classes + gt_labels.to(torch.int64)
    flat = torch.where(valid, flat, n_classes * n_classes)
    counts = torch.bincount(flat, minlength=n_classes * n_classes + 1)
    return counts[:-1].reshape(n_classes, n_classes).to(torch.int32)


def _zero_ignored(cm):
    cm = torch.as_tensor(cm).to(torch.float32).clone()
    cm[:, list(IGNORE_INDEX)] = 0.0
    return cm


def iou_from_confusion(cm):
    """Per-class IoU; the ignored classes' ground-truth columns zeroed."""
    cm = _zero_ignored(cm)
    tp = torch.diag(cm)
    fp = cm.sum(dim=1) - tp
    fn = cm.sum(dim=0) - tp
    return tp / (tp + fp + fn + 1e-15)


def accuracy_from_confusion(cm):
    cm = _zero_ignored(cm)
    tp = torch.diag(cm)
    fp = cm.sum(dim=1) - tp
    return tp.sum() / (tp.sum() + fp.sum() + 1e-15)


def detection_recall(pred_boxes, pred_mask, gt_boxes, num_gt, thresh_list):
    """Recalled count per threshold and the ground-truth count. pred_boxes
    (K, 7+), gt_boxes (M, 7+); rows past num_gt and all-zero rows are not
    ground truth."""
    M = gt_boxes.shape[0]
    gt_ok = (torch.arange(M, device=gt_boxes.device) < num_gt) & (
        gt_boxes.abs().sum(dim=-1) > 0)
    iou = boxes_iou3d(pred_boxes[:, :7], gt_boxes[:, :7])
    iou = torch.where(pred_mask[:, None] & gt_ok[None, :], iou, 0.0)
    best = iou.max(dim=0).values
    out = {f"rcnn_{t}": (gt_ok & (best > t)).sum() for t in thresh_list}
    out["gt"] = gt_ok.sum()
    return out
