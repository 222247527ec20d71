"""Greedy rotated NMS in float64 NumPy for the reference: visit the
candidates in the order given (score-descending), keep a box unless a kept
box overlaps it in bird's-eye view with IoU above the threshold, stop at
``max_out`` keepers. The overlap of two rotated rectangles is the area of
one clipped by the other's four edges (Sutherland-Hodgman)."""

from __future__ import annotations

import numpy as np


def corners(b) -> np.ndarray:
    """(4, 2) counter-clockwise corners of box [x, y, z, dx, dy, dz, yaw]."""
    hx, hy = 0.5 * b[3], 0.5 * b[4]
    c, s = np.cos(b[6]), np.sin(b[6])
    local = np.array([[hx, hy], [-hx, hy], [-hx, -hy], [hx, -hy]])
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + b[None, 0:2]


def _clip(poly, a, b):
    """The part of polygon ``poly`` left of the directed edge a -> b."""
    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        sp = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        sq = (b[0] - a[0]) * (q[1] - a[1]) - (b[1] - a[1]) * (q[0] - a[0])
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            t = sp / (sp - sq)
            out.append(p + t * (q - p))
    return out


def _area(poly) -> float:
    if len(poly) < 3:
        return 0.0
    p = np.asarray(poly)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def iou_bev(a, b) -> float:
    ca, cb = corners(a), corners(b)
    poly = list(ca)
    for e in range(4):
        if not poly:
            break
        poly = _clip(poly, cb[e], cb[(e + 1) % 4])
    inter = _area(poly)
    union = a[3] * a[4] + b[3] * b[4] - inter
    return inter / max(union, 1e-12)


def greedy_rotated_nms(boxes: np.ndarray, thresh: float, max_out: int):
    """Indices (into ``boxes``, in order) of the kept boxes."""
    kept = []
    r = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4])
    for j in range(len(boxes)):
        ok = True
        for i in kept:
            if np.hypot(*(boxes[i, :2] - boxes[j, :2])) > r[i] + r[j]:
                continue  # disjoint rectangles: IoU 0
            if iou_bev(boxes[i], boxes[j]) > thresh:
                ok = False
                break
        if ok:
            kept.append(j)
            if len(kept) == max_out:
                break
    return kept
