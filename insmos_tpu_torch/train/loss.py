"""Losses (port of insmos_tpu/train/loss.py).

- mos_loss: the reference MOSLoss: NLL over log-softmax with the ignored
  class's logit forced to -inf and its class weight zeroed (weights
  normalised to sum 1), torch-NLL weighted-mean reduction.
- gaussian_focal_loss: CornerNet-style heatmap focal loss (alpha 2, gamma
  4, sigmoid clipped at 1e-4), over the number of peak cells.
- reg_l1_loss: masked L1 on the gathered box codes, over the number of
  valid boxes.
"""

from __future__ import annotations

import torch

from ..constants import IGNORE_INDEX


def mos_loss(logits, labels, valid):
    """logits (N, C), labels (N,) int, valid (N,) bool -> scalar."""
    C = logits.shape[-1]
    ignore = torch.zeros(C, dtype=torch.bool, device=logits.device)
    ignore[list(IGNORE_INDEX)] = True
    w = torch.where(ignore, 0.0, 1.0)
    w = w / w.sum()
    masked = torch.where(ignore[None, :], float("-inf"), logits)
    logp = torch.log(torch.clamp(torch.softmax(masked, dim=-1), min=1e-8))
    lab = labels.to(torch.int64)
    nll = -torch.gather(logp, 1, lab[:, None])[:, 0]
    wi = w[lab] * valid.to(logits.dtype)
    return (nll * wi).sum() / torch.clamp(wi.sum(), min=1e-12)


def gaussian_focal_loss(cls_logits, heatmap, *, alpha=2.0, gamma=4.0):
    """cls_logits (H, W, C) raw; heatmap (C, H, W) gaussian targets."""
    pred = torch.clamp(torch.sigmoid(cls_logits), 1e-4, 1 - 1e-4)
    pred = pred.permute(2, 0, 1)
    eps = 1e-12
    pos_w = (heatmap == 1.0).to(pred.dtype)
    neg_w = torch.pow(1.0 - heatmap, gamma)
    pos = -torch.log(pred + eps) * torch.pow(1 - pred, alpha) * pos_w
    neg = -torch.log(1 - pred + eps) * torch.pow(pred, alpha) * neg_w
    num_pos = torch.clamp(pos_w.sum(), min=1.0)
    return (pos + neg).sum() / num_pos


def reg_l1_loss(box_map, anno_boxes, inds, mask, code_weights):
    """box_map (H, W, 8); anno (M, 8); inds (M,) flat y*W+x; mask (M,)."""
    H, W, C = box_map.shape
    pred = box_map.reshape(H * W, C)[inds.to(torch.int64)]
    cw = torch.tensor(code_weights, dtype=box_map.dtype,
                      device=box_map.device)
    m = mask.to(box_map.dtype)[:, None] * cw[None, :]
    m = m * torch.isfinite(anno_boxes).to(box_map.dtype)
    num = torch.clamp(mask.sum().to(box_map.dtype), min=0.0)
    loss = torch.abs(pred - torch.nan_to_num(anno_boxes)) * m
    return loss.sum() / (num + 1e-4)
