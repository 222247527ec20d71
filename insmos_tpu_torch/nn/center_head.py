"""CenterPoint-style detection head and post-processing (port of
insmos_tpu/nn/center_head.py): 1x1 convs to a class heatmap and an 8-channel
box code, then sigmoid scores, score gate, top-K, greedy rotated NMS."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.box_utils import decode_center_boxes
from ..ops.nms import greedy_nms
from .layers import cast_compute, mm


class Head1x1(nn.Module):
    """1x1 conv ``w`` (1, 1, cin, cout) (JAX HWIO) and bias ``b``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(1, 1, cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))


class CenterHead(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c_in = cfg.model.bev.num_upsample_filters[0]
        self.cls = Head1x1(c_in, cfg.model.head.num_class)
        self.box = Head1x1(c_in, 8)


def center_head_forward(p: CenterHead, feat, dtype=None):
    """feat (H, W, C) -> (cls_logits (H, W, nc), box_preds (H, W, 8))."""
    cls = mm(feat, cast_compute(p.cls.w, dtype)[0, 0]) + p.cls.b
    box = mm(feat, cast_compute(p.box.w, dtype)[0, 0]) + p.box.b
    return cls, box


def _top_k(scores, k):
    """Descending top-k with ties by index (lax.top_k order)."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    return scores[idx], idx


def decode_and_nms(cfg, cls_logits, box_preds):
    """Dense maps -> (boxes (Npost, 8) incl. class column, scores, labels,
    valid mask)."""
    pp = cfg.model.post
    boxes = decode_center_boxes(box_preds, cfg.data.voxel_size,
                                cfg.data.point_cloud_range,
                                cfg.model.head.out_size_factor)
    scores_all = torch.sigmoid(cls_logits.reshape(-1, cls_logits.shape[-1]))
    if pp.multi_classes_nms:
        return _multi_classes_nms(cfg, boxes, scores_all)
    scores, labels = scores_all.max(dim=-1)
    labels = labels.to(torch.int32) + 1
    gate = scores >= pp.score_thresh
    k = min(pp.nms_pre_maxsize, scores.shape[0])
    top_scores, top_idx = _top_k(torch.where(gate, scores, -1.0), k)
    top_boxes = boxes[top_idx]
    top_labels = labels[top_idx]
    keep_idx, keep_mask = greedy_nms(top_boxes, top_scores,
                                     top_scores >= pp.score_thresh,
                                     pp.nms_thresh, pp.nms_post_maxsize)
    ki = keep_idx.to(torch.int64)
    sel_boxes = torch.where(keep_mask[:, None], top_boxes[ki], 0.0)
    sel_scores = torch.where(keep_mask, top_scores[ki], 0.0)
    sel_labels = torch.where(keep_mask, top_labels[ki], 0)
    boxes8 = torch.cat([sel_boxes, sel_labels[:, None].to(sel_boxes.dtype)],
                       dim=-1)
    return boxes8, sel_scores, sel_labels, keep_mask


def _multi_classes_nms(cfg, boxes, scores_all):
    """Per-class NMS; keeps re-capped to nms_post_maxsize by score."""
    pp = cfg.model.post
    nc = scores_all.shape[-1]
    k = min(pp.nms_pre_maxsize, scores_all.shape[0])
    cb, cs, cl, cm = [], [], [], []
    for c in range(nc):
        s = scores_all[:, c]
        top_s, top_i = _top_k(torch.where(s >= pp.score_thresh, s, -1.0), k)
        top_b = boxes[top_i]
        keep_idx, keep_mask = greedy_nms(top_b, top_s,
                                         top_s >= pp.score_thresh,
                                         pp.nms_thresh, pp.nms_post_maxsize)
        ki = keep_idx.to(torch.int64)
        cb.append(top_b[ki])
        cs.append(torch.where(keep_mask, top_s[ki], 0.0))
        cl.append(torch.full((ki.shape[0],), c + 1, dtype=torch.int32,
                             device=boxes.device))
        cm.append(keep_mask)
    cb, cs, cl, cm = (torch.cat(a) for a in (cb, cs, cl, cm))
    top_s, top_i = _top_k(torch.where(cm, cs, -1.0), pp.nms_post_maxsize)
    mask = top_s > 0.0
    sel_boxes = torch.where(mask[:, None], cb[top_i], 0.0)
    sel_labels = torch.where(mask, cl[top_i], 0)
    sel_scores = torch.where(mask, top_s, 0.0)
    boxes8 = torch.cat([sel_boxes, sel_labels[:, None].to(sel_boxes.dtype)],
                       dim=-1)
    return boxes8, sel_scores, sel_labels, mask
