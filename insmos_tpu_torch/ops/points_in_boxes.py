"""Point-in-rotated-box tests on the device (port of
insmos_tpu/ops/points_in_boxes.py): translate by the box centre, rotate
into the box frame, test |rx| <= dx/2, |ry| <= dy/2, |dz| <= dz/2.

Where boxes of one class overlap, :func:`points_in_instance_boxes` gives
the largest box index, as the reference defines it (its OpenMP original
lets the last writer win)."""

from __future__ import annotations

import numpy as np
import torch


def _in_box(points, boxes):
    d = points[:, None, :3] - boxes[None, :, :3]
    cos = torch.cos(boxes[:, 6])[None]
    sin = torch.sin(boxes[:, 6])[None]
    rx = d[..., 0] * cos + d[..., 1] * sin
    ry = -d[..., 0] * sin + d[..., 1] * cos
    half = boxes[None, :, 3:6] * 0.5
    return ((rx.abs() <= half[..., 0]) & (ry.abs() <= half[..., 1])
            & (d[..., 2].abs() <= half[..., 2]))


def points_in_rotated_boxes(points, boxes, box_valid=None):
    """(N, M) bool: point n inside rotated box m."""
    inside = _in_box(points, boxes)
    if box_valid is not None:
        inside = inside & box_valid[None, :]
    return inside


def box_class_features(coords, boxes, num_classes: int, box_valid=None):
    """(N, num_classes) {0, 1}: per-class membership of each position in
    the boxes (M, 8) [x, y, z, dx, dy, dz, yaw, class (1-indexed)];
    class <= 0 rows are ignored."""
    cls = boxes[:, 7].to(torch.int64)
    valid = cls > 0
    if box_valid is not None:
        valid = valid & box_valid
    inside = points_in_rotated_boxes(coords, boxes, valid)
    onehot = ((cls[:, None] - 1) == torch.arange(
        num_classes, device=boxes.device)[None, :]).to(torch.float32)
    return torch.clamp(inside.to(torch.float32) @ onehot, max=1.0)


def points_in_instance_boxes(points, boxes, num_classes: int,
                             ground_offset: float = 0.0, box_valid=None):
    """(N, num_classes) int32 per-class instance ids: box index + 1 of the
    box of that class that holds the point, 0 for none, the largest index
    where boxes overlap. Box centres are lifted by ``ground_offset`` first,
    to shed ground points; boxes (M, 8) [x, y, z, dx, dy, dz, yaw, class
    (1-indexed)], class <= 0 rows ignored."""
    lifted = boxes.clone()
    lifted[:, 2] += ground_offset
    cls = lifted[:, 7].to(torch.int64)
    valid = cls > 0
    if box_valid is not None:
        valid = valid & box_valid
    inside = points_in_rotated_boxes(points, lifted, valid)  # (N, M)
    ids = torch.arange(1, boxes.shape[0] + 1, device=boxes.device)
    per_class = (cls[:, None] - 1) == torch.arange(
        num_classes, device=boxes.device)[None, :]  # (M, C)
    contrib = inside[:, :, None] * (ids[None, :, None] * per_class[None])
    return contrib.amax(dim=1).to(torch.int32)


def points_in_rotated_boxes_np(points: np.ndarray,
                               boxes: np.ndarray) -> np.ndarray:
    """Numpy version for tests: (N, M) bool membership (same math)."""
    d = points[:, None, :3] - boxes[None, :, :3]
    cos = np.cos(boxes[:, 6])[None]
    sin = np.sin(boxes[:, 6])[None]
    rx = d[..., 0] * cos + d[..., 1] * sin
    ry = -d[..., 0] * sin + d[..., 1] * cos
    half = boxes[None, :, 3:6] * 0.5
    return ((np.abs(rx) <= half[..., 0]) & (np.abs(ry) <= half[..., 1])
            & (np.abs(d[..., 2]) <= half[..., 2]))
