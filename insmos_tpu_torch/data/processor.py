"""Point and box range filtering (the port's own copy of
``insmos_tpu/data/processor.py``; tests/test_torch_train_data.py holds the
two equal). The range mask is x/y only, as the reference's: z passes and
the voxelizer drops out-of-z points later. A box is kept when at least one
corner lies inside the full 3D range."""

from __future__ import annotations

import numpy as np


def mask_points_by_range(points: np.ndarray, limit_range) -> np.ndarray:
    """Boolean mask of points inside the x/y range (z intentionally ignored)."""
    return (
        (points[:, 0] >= limit_range[0])
        & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1])
        & (points[:, 1] <= limit_range[4])
    )


def rotate_points_z(points: np.ndarray, angle: float) -> np.ndarray:
    """Rotate (N, 3+) points about z (points @ R with R rows [cos, sin],
    [-sin, cos], the reference's convention)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    out = points.copy()
    out[:, 0:3] = points[:, 0:3] @ rot
    return out


def boxes_to_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) center-format boxes -> (N, 8, 3) corners."""
    template = (
        np.array(
            [
                [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
                [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
            ],
            dtype=np.float64,
        )
        / 2.0
    )
    corners = boxes[:, None, 3:6] * template[None]
    out = np.stack(
        [rotate_points_z(corners[i], boxes[i, 6]) for i in range(len(boxes))]
    ) if len(boxes) else corners
    return out + boxes[:, None, 0:3]


def mask_boxes_outside_range(
    boxes: np.ndarray, limit_range, min_num_corners: int = 1
) -> np.ndarray:
    """Keep boxes with >= min_num_corners corners inside the 3D range."""
    if len(boxes) == 0:
        return np.zeros((0,), dtype=bool)
    corners = boxes_to_corners_3d(boxes[:, 0:7])
    lo = np.asarray(limit_range[0:3])
    hi = np.asarray(limit_range[3:6])
    inside = ((corners >= lo) & (corners <= hi)).all(axis=2)
    return inside.sum(axis=1) >= min_num_corners
