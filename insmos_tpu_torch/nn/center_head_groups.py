"""CenterPoint's head with class groups (OpenPCDet ``dense_heads/
center_head.py``): a shared 3x3 conv with BN and ReLU, then per class
group one ``SeparateHead``: each of its heads (``center``, ``center_z``,
``dim``, ``rot``, ``vel`` and the group's heatmap ``hm``) a 3x3 conv with
bias, BN and ReLU, then a 3x3 conv with bias to the head's channels. BN is
``nn.BatchNorm2d``'s (eps 1e-5).

Decode, per group: scores ``sigmoid(hm)``, the top ``max_obj_per_group``
over (class, cell) in descending order with ties by flat index (class
major), x = (col + center_x) x stride x voxel + range lo (y likewise), z =
``center_z``, sizes ``exp(dim)``, yaw ``atan2(sin, cos)``, the velocity as
is; a box is a candidate when its score is above the gate and its centre
inside the limit range, and at most ``nms_pre_maxsize`` candidates go on.
NMS: class-agnostic rotated BEV NMS inside each group, every group one
slot of a single :func:`~insmos_tpu_torch.ops.nms.greedy_nms_slots` call
(one host copy for all groups).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.nms import greedy_nms_slots
from .layers import BatchNorm, cast_compute, conv2d, relu

_MOMENTUM = 0.1  # nn.BatchNorm2d's


class ConvB(nn.Module):
    """3x3 conv weight ``w`` (cout, cin, 3, 3) and bias ``b``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.b = nn.Parameter(torch.zeros(cout))


class ConvBNB(nn.Module):
    """``conv`` (with bias) then ``bn``."""

    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__()
        self.conv = ConvB(cin, cout)
        self.bn = BatchNorm(cout, eps, _MOMENTUM)


class SepHead(nn.Module):
    """One head: ``conv1`` with ``bn``, then ``conv2`` to ``cout``."""

    def __init__(self, c: int, cout: int, eps: float):
        super().__init__()
        self.conv1 = ConvB(c, c)
        self.bn = BatchNorm(c, eps, _MOMENTUM)
        self.conv2 = ConvB(c, cout)


class CenterHeadGroups(nn.Module):
    """Parameters ``shared`` and ``groups.<g>.<head>``."""

    def __init__(self, cfg):
        super().__init__()
        h = cfg.model.head
        c = h.head_channels
        self.shared = ConvBNB(sum(cfg.model.bev.num_upsample_filters),
                              h.shared_channels, h.bn_eps)
        self.groups = nn.ModuleList()
        for classes in h.groups:
            heads = dict(h.heads)
            heads["hm"] = len(classes)
            self.groups.append(nn.ModuleDict(
                {name: SepHead(c, n, h.bn_eps) for name, n in heads.items()}))


def _conv(x, p: ConvB, dtype):
    return conv2d(x, cast_compute(p.w, dtype)) + p.b.view(1, -1, 1, 1)


def _bn(bn: BatchNorm, x):
    """Eval-mode BN over the channels of (1, C, H, W)."""
    return bn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def head_names(cfg) -> tuple:
    """The heads of a group in order: the regression heads, then ``hm``."""
    return tuple(n for n, _ in cfg.model.head.heads) + ("hm",)


def center_head_groups_forward(p: CenterHeadGroups, cfg, feat, dtype=None):
    """feat (H, W, C) -> per group {head: (cout, H, W)} float32."""
    x = feat.permute(2, 0, 1)[None]
    x = relu(_bn(p.shared.bn, _conv(x, p.shared.conv, dtype)))
    maps = []
    for grp in p.groups:
        out = {}
        for name in head_names(cfg):
            hp = grp[name]
            y = relu(_bn(hp.bn, _conv(x, hp.conv1, dtype)))
            out[name] = _conv(y, hp.conv2, dtype)[0]
        maps.append(out)
    return maps


def label_table(cfg) -> torch.Tensor:
    """(G, classes of the widest group) int32: each group's nuScenes label
    ids by class, 0 past a group's classes."""
    labels = cfg.class_labels
    table = torch.zeros((len(labels), max(map(len, labels))),
                        dtype=torch.int32)
    for g, ids in enumerate(labels):
        table[g, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    return table


def decode_groups(cfg, maps, table):
    """Per-group top-K decode; ``table``: :func:`label_table` on the maps'
    device. Returns (boxes (G, K, 9): x, y, z, dx, dy,
    dz, yaw, vx, vy; scores (G, K); labels (G, K) int32 nuScenes ids;
    candidates (G, K) bool), each group's rows in descending score."""
    pp, h, d = cfg.model.post, cfg.model.head, cfg.data
    G = len(maps)
    ncmax = max(m["hm"].shape[0] for m in maps)
    _, H, W = maps[0]["hm"].shape
    HW = H * W
    hm = torch.stack([torch.cat([m["hm"], m["hm"].new_full(
        (ncmax - m["hm"].shape[0], H, W), -float("inf"))]) for m in maps])
    scores_all = torch.sigmoid(hm).reshape(G, ncmax * HW)
    K = min(pp.max_obj_per_group, ncmax * HW)
    srt = torch.sort(scores_all, dim=1, descending=True, stable=True)
    top_s, top_i = srt.values[:, :K], srt.indices[:, :K]
    cls = top_i // HW
    cell = top_i % HW
    ys = (cell // W).to(torch.float32)
    xs = (cell % W).to(torch.float32)
    reg = torch.stack([torch.cat([m[n] for n, _ in h.heads]) for m in maps])
    r = reg.reshape(G, -1, HW).gather(
        2, cell[:, None, :].expand(G, reg.shape[1], K))
    osf = h.out_size_factor
    lo = d.point_cloud_range
    x = (xs + r[:, 0]) * osf * d.voxel_size[0] + lo[0]
    y = (ys + r[:, 1]) * osf * d.voxel_size[1] + lo[1]
    z = r[:, 2]
    boxes = torch.stack([x, y, z, torch.exp(r[:, 3]), torch.exp(r[:, 4]),
                         torch.exp(r[:, 5]), torch.atan2(r[:, 7], r[:, 6]),
                         r[:, 8], r[:, 9]], dim=-1)
    lim = pp.center_limit_range
    cand = top_s > pp.score_thresh
    for i, v in enumerate((x, y, z)):
        cand = cand & (v >= lim[i]) & (v <= lim[i + 3])
    cand = cand & (torch.cumsum(cand.to(torch.int32), 1) <= pp.nms_pre_maxsize)
    labels = table.gather(1, cls)
    return boxes, top_s, labels, cand


def nms_groups(cfg, boxes, scores, labels, cand):
    """Each group's NMS as one slot of one call. Returns (boxes (G * M, 9),
    scores, labels, mask), M = ``nms_post_maxsize``, group after group,
    each in descending score."""
    pp = cfg.model.post
    keep_idx, keep_mask = greedy_nms_slots(boxes, scores, cand,
                                           pp.nms_thresh, pp.nms_post_maxsize)
    ki = keep_idx.to(torch.int64)
    sel_boxes = torch.where(keep_mask[..., None], boxes.gather(
        1, ki[..., None].expand(*ki.shape, boxes.shape[-1])), 0.0)
    sel_scores = torch.where(keep_mask, scores.gather(1, ki), 0.0)
    sel_labels = torch.where(keep_mask, labels.gather(1, ki), 0)
    return (sel_boxes.reshape(-1, boxes.shape[-1]), sel_scores.reshape(-1),
            sel_labels.reshape(-1), keep_mask.reshape(-1))
