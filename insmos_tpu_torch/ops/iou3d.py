"""Rotated-box BEV overlap and IoU (port of insmos_tpu/ops/iou3d.py).

Exact convex intersection of two rotated rectangles by Sutherland-Hodgman
clipping (rect A clipped by the 4 half-planes of rect B) on fixed 8-vertex
polygon buffers, vectorised over box pairs. Polygons are carried as
(V, K) coordinate planes, vertex slots by box pairs, as in the reference.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_MAX_VERTS = 8


def boxes_to_corners_bev(boxes):
    """(M, 7) -> (M, 4, 2) CCW BEV corners."""
    hx, hy = boxes[:, 3] * 0.5, boxes[:, 4] * 0.5
    local = torch.stack([torch.stack([hx, hy], -1), torch.stack([-hx, hy], -1),
                         torch.stack([-hx, -hy], -1),
                         torch.stack([hx, -hy], -1)], dim=1)
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return torch.stack([x, y], -1) + boxes[:, None, 0:2]


def _next_t(p, count, iv):
    """Cyclic successor along the vertex axis: slot i -> i+1, wrapping to
    slot 0 where i+1 == count."""
    n = torch.roll(p, -1, dims=0)
    return torch.where(iv + 1 == count[None, :], p[0][None, :], n)


def _clip_halfplane_t(px, py, count, ax, ay, bx, by):
    V, K = px.shape
    iv = torch.arange(V, device=px.device)[:, None]
    ex, ey = bx - ax, by - ay
    s = ex[None] * (py - ay[None]) - ey[None] * (px - ax[None])
    nx = _next_t(px, count, iv)
    ny = _next_t(py, count, iv)
    ns = _next_t(s, count, iv)
    in_cur = s >= -_EPS
    in_nxt = ns >= -_EPS
    alive = iv < count[None, :]
    d = s - ns
    t = s / torch.where(d.abs() < _EPS, torch.full_like(d, _EPS), d)
    t = t.clamp(0.0, 1.0)
    ix = px + t * (nx - px)
    iy = py + t * (ny - py)
    emit_x = torch.stack([px, ix], dim=1).reshape(2 * V, K)
    emit_y = torch.stack([py, iy], dim=1).reshape(2 * V, K)
    emit_f = torch.stack([in_cur & alive, (in_cur ^ in_nxt) & alive],
                         dim=1).reshape(2 * V, K)
    pos = torch.cumsum(emit_f.to(torch.int32), 0) - 1
    new_count = torch.clamp(pos[-1] + 1, min=0) * emit_f.any(dim=0)
    outx, outy = [], []
    for j in range(V):
        selj = (pos == j) & emit_f
        outx.append(torch.where(selj, emit_x, 0.0).sum(0))
        outy.append(torch.where(selj, emit_y, 0.0).sum(0))
    return (torch.stack(outx), torch.stack(outy),
            torch.clamp(new_count, max=V).to(torch.int32))


def _polygon_area_t(px, py, count):
    V, K = px.shape
    iv = torch.arange(V, device=px.device)[:, None]
    nx = _next_t(px, count, iv)
    ny = _next_t(py, count, iv)
    cross = torch.where(iv < count[None, :], px * ny - py * nx, 0.0)
    return 0.5 * cross.sum(0).abs()


def overlap_bev_pairs(boxes_a, boxes_b):
    """Exact BEV intersection area of paired boxes: (K, 7), (K, 7) -> (K,)."""
    boxes_a = boxes_a.float()
    boxes_b = boxes_b.float()
    K = boxes_a.shape[0]
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    zeros = ca.new_zeros((_MAX_VERTS - 4, K))
    px = torch.cat([ca[:, :, 0].T, zeros])
    py = torch.cat([ca[:, :, 1].T, zeros])
    count = torch.full((K,), 4, dtype=torch.int32, device=ca.device)
    for e in range(4):
        a_pt, b_pt = cb[:, e], cb[:, (e + 1) % 4]
        px, py, count = _clip_halfplane_t(px, py, count, a_pt[:, 0],
                                          a_pt[:, 1], b_pt[:, 0], b_pt[:, 1])
    area = _polygon_area_t(px, py, count)
    # degenerate (zero-size) rects have no half-planes to clip by; the
    # intersection is bounded by both areas
    return torch.minimum(area, torch.minimum(boxes_a[:, 3] * boxes_a[:, 4],
                                             boxes_b[:, 3] * boxes_b[:, 4]))


def rotated_overlap_bev(boxes_a, boxes_b):
    """Exact BEV intersection area: (A, 7) x (B, 7) -> (A, B)."""
    A, B = boxes_a.shape[0], boxes_b.shape[0]
    pa = boxes_a[:, None].expand(A, B, boxes_a.shape[1]).reshape(A * B, -1)
    pb = boxes_b[None].expand(A, B, boxes_b.shape[1]).reshape(A * B, -1)
    return overlap_bev_pairs(pa, pb).reshape(A, B)


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU (A, 7) x (B, 7) -> (A, B)."""
    inter = rotated_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None].float()
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :].float()
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def iou_bev_pairs(boxes_a, boxes_b):
    """Rotated BEV IoU of paired boxes: (K, 7), (K, 7) -> (K,)."""
    inter = overlap_bev_pairs(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4]).float()
    area_b = (boxes_b[:, 3] * boxes_b[:, 4]).float()
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def boxes_iou3d(boxes_a, boxes_b):
    """Rotated 3D IoU (A, 7) x (B, 7) -> (A, B): the BEV intersection times
    the z overlap, over the union volume."""
    boxes_a, boxes_b = boxes_a.float(), boxes_b.float()
    inter_bev = rotated_overlap_bev(boxes_a, boxes_b)
    a_zmin = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    a_zmax = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    b_zmin = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    b_zmax = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    overlap_z = torch.clamp(torch.minimum(a_zmax, b_zmax)
                            - torch.maximum(a_zmin, b_zmin), min=0.0)
    inter = inter_bev * overlap_z
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-6)
