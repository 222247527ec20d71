"""Greedy rotated NMS (port of insmos_tpu/ops/nms.py, ``greedy_nms``).

Semantics of the reference's one-keeper-per-iteration loop: visit boxes in
descending score order (ties by index); keep a box iff no already-kept box
overlaps it with BEV IoU above the threshold; stop at ``max_out`` keepers.

Design: the overlap relation is worked out once on the device and the
greedy scan runs on the host over it, as the reference's CUDA NMS does
(bitmask kernel + host scan). Only score-ordered pairs (i before j) whose
bounding circles touch are evaluated: for a threshold >= 0 a pair of
disjoint rectangles has IoU 0 and can suppress nothing, so the result is
the full-matrix result. Three host syncs per call: the live-box count, the
candidate pair list, and the suppressing pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from .iou3d import boxes_iou_bev, iou_bev_pairs

_MARGIN = 1e-2  # metres added to the bounding-circle test


def greedy_nms(boxes, scores, valid, iou_thresh: float, max_out: int):
    """boxes (K, 7+), scores (K,), valid (K,) bool -> (keep_idx (max_out,)
    int32 score-descending, keep_mask (max_out,) bool)."""
    dev = boxes.device
    ms = torch.where(valid, scores.float(),
                     torch.full_like(scores, -float("inf"), dtype=torch.float32))
    order = torch.sort(ms, descending=True, stable=True).indices
    n = int((ms > -float("inf")).sum())
    keep_idx = torch.zeros(max_out, dtype=torch.int32, device=dev)
    keep_mask = torch.zeros(max_out, dtype=torch.bool, device=dev)
    if n == 0:
        return keep_idx, keep_mask
    cand = order[:n]
    b = boxes[cand, :7].float()
    if iou_thresh >= 0:
        r = 0.5 * torch.hypot(b[:, 3], b[:, 4])
        dist = torch.cdist(b[:, :2], b[:, :2],
                           compute_mode="donot_use_mm_for_euclid_dist")
        close = dist <= r[:, None] + r[None, :] + _MARGIN
        close = torch.triu(close, diagonal=1)
        ij = torch.nonzero(close)  # row-major: sorted by i, then j
        over = iou_bev_pairs(b[ij[:, 0]], b[ij[:, 1]]) > iou_thresh
        ij = ij[over].cpu().numpy()
    else:
        over = boxes_iou_bev(b, b) > iou_thresh
        ij = torch.nonzero(torch.triu(over, diagonal=1)).cpu().numpy()
    starts = np.searchsorted(ij[:, 0], np.arange(n + 1))
    suppressed = np.zeros(n, bool)
    kept = []
    for i in range(n):
        if suppressed[i]:
            continue
        kept.append(i)
        if len(kept) == max_out:
            break
        suppressed[ij[starts[i]:starts[i + 1], 1]] = True
    k = len(kept)
    kept_t = torch.from_numpy(np.asarray(kept, np.int64)).to(dev)
    keep_idx[:k] = cand[kept_t].to(torch.int32)
    keep_mask[:k] = True
    return keep_idx, keep_mask
