"""Greedy rotated NMS (port of insmos_tpu/ops/nms.py, ``greedy_nms``).

Semantics of the reference's one-keeper-per-iteration loop: visit boxes in
descending score order (ties by index); keep a box iff no already-kept box
overlaps it with BEV IoU above the threshold; stop at ``max_out`` keepers.

Design: the overlap relation is worked out on the device and the greedy
scan runs on the host over it, as the reference's CUDA NMS does (bitmask
kernel + host scan). Only score-ordered pairs (i before j) of live boxes
whose bounding circles touch are evaluated: for a threshold >= 0 a pair of
disjoint rectangles has IoU 0 and can suppress nothing, so the result is
the full-matrix result. The device half runs over a leading slot axis
(:func:`greedy_nms_slots`): every slot's candidate count, (K, K) distance
matrix and circle test, and one fixed-capacity pair list
(``torch.nonzero_static``, no host sync) with each pair's IoU test; then
ONE device-to-host copy carries all slots' counts and overlapping pairs,
the host scans each slot, and one host-to-device copy brings the keepers
back. Only a pair list above its capacity (``PAIRS_PER_BOX`` pairs a box)
costs a second copy, for the exact full list. The copies and those
overflows, the rows tested (slots x K), the live candidates among them and
the boxes kept are counted in :mod:`insmos_tpu_torch.obs` (``nms.*``).

``greedy_nms`` is the op ``insmos::greedy_nms`` (a ``torch.library`` custom
op) on one slot; its batching rule runs :func:`greedy_nms_slots` once over
the slot axis of a ``torch.func.vmap`` (the multi-stream pod's step).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from .iou3d import iou_bev_pairs

_MARGIN = 1e-2  # metres added to the bounding-circle test
PAIRS_PER_BOX = 24  # pair-list capacity a candidate box, before a second copy


def _greedy_host(n: int, ij: np.ndarray, max_out: int) -> list[int]:
    """The greedy scan of one slot: ``n`` score-ordered candidates, ``ij``
    (P, 2) overlapping pairs (i < j), sorted by i. Returns the kept
    positions, in order."""
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
    return kept


def greedy_nms_slots(boxes, scores, valid, iou_thresh: float, max_out: int):
    """boxes (S, K, 7+), scores (S, K), valid (S, K) bool -> (keep_idx
    (S, max_out) int32 score-descending, keep_mask (S, max_out) bool), each
    slot as :func:`greedy_nms` on its own rows, with one device-to-host
    copy for all slots."""
    with obs.span("nms"):
        return _greedy_nms_slots(boxes, scores, valid, iou_thresh, max_out)


def _greedy_nms_slots(boxes, scores, valid, iou_thresh, max_out):
    dev = boxes.device
    S, K = scores.shape
    ms = torch.where(valid, scores.float(), torch.full_like(
        scores, -float("inf"), dtype=torch.float32))
    order = torch.sort(ms, dim=1, descending=True, stable=True).indices
    n = (ms > -float("inf")).sum(dim=1)
    b = torch.gather(boxes[..., :7].float(), 1,
                     order[..., None].expand(S, K, 7))
    # candidate pairs i < j < n (both live: live boxes lead the order)
    live = torch.arange(K, device=dev)[None, :] < n[:, None]
    pairs = torch.triu(live[:, None, :].expand(S, K, K), diagonal=1)
    if iou_thresh >= 0:
        r = 0.5 * torch.hypot(b[..., 3], b[..., 4])
        dist = torch.cdist(b[..., :2], b[..., :2],
                           compute_mode="donot_use_mm_for_euclid_dist")
        pairs = pairs & (dist <= r[:, :, None] + r[:, None, :] + _MARGIN)
    flat = pairs.reshape(-1)
    cap = max(1, S * K * PAIRS_PER_BOX)
    # row-major flat index (slot, i, j): sorted by slot, then i, then j
    idx = torch.nonzero_static(flat, size=cap, fill_value=-1)[:, 0]

    def overlapping(idx):
        s, i, j = idx // (K * K), (idx // K) % K, idx % K
        return iou_bev_pairs(b[s, i], b[s, j]) > iou_thresh

    over = overlapping(idx.clamp(min=0)) & (idx >= 0)
    with obs.span("sync.nms"):
        host = torch.cat([n, flat.sum().reshape(1),
                          torch.where(over, idx, -1)]).cpu().numpy()
    obs.count("nms.copies")
    n_h, total, idx_h = host[:S], int(host[S]), host[S + 1:]
    obs.count("nms.rows", S * K)
    obs.count("nms.live", int(n_h.sum()))
    if total > cap:  # the list outgrew its capacity: the exact full list
        with obs.span("sync.nms"):
            idx = torch.nonzero(flat)[:, 0]
            idx_h = torch.where(overlapping(idx), idx, -1).cpu().numpy()
        obs.count("nms.copies")
        obs.count("nms.pair_overflows")
    idx_h = idx_h[idx_h >= 0]
    slot = idx_h // (K * K)
    ij = np.stack([(idx_h // K) % K, idx_h % K], axis=1)
    kept = np.full((S, max_out), -1, np.int64)
    bounds = np.searchsorted(slot, np.arange(S + 1))
    for s in range(S):
        k = _greedy_host(int(n_h[s]), ij[bounds[s]:bounds[s + 1]], max_out)
        kept[s, :len(k)] = k
    obs.count("nms.kept", int((kept >= 0).sum()))
    kept = torch.from_numpy(kept).to(dev)
    keep_mask = kept >= 0
    keep_idx = torch.where(keep_mask, order.gather(1, kept.clamp(min=0)), 0)
    return keep_idx.to(torch.int32), keep_mask


@torch.library.custom_op("insmos::greedy_nms", mutates_args=())
def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               iou_thresh: float, max_out: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """boxes (K, 7+), scores (K,), valid (K,) bool -> (keep_idx (max_out,)
    int32 score-descending, keep_mask (max_out,) bool)."""
    keep_idx, keep_mask = greedy_nms_slots(boxes[None], scores[None],
                                           valid[None], iou_thresh, max_out)
    return keep_idx[0].clone(), keep_mask[0].clone()


@greedy_nms.register_vmap
def _greedy_nms_vmap(info, in_dims, boxes, scores, valid, iou_thresh,
                     max_out):
    """Every slot of a vmapped call in one greedy_nms_slots: one
    device-to-host copy however many slots."""
    S = info.batch_size

    def slots(t, d):
        return t.movedim(d, 0) if d is not None else t.expand(S, *t.shape)

    out = greedy_nms_slots(slots(boxes, in_dims[0]), slots(scores, in_dims[1]),
                           slots(valid, in_dims[2]), iou_thresh, max_out)
    return out, (0, 0)
