"""Training augmentations applied jointly to the whole scan window and its
boxes, in the reference's order: flip about x (p = 0.5), rotation in
[-pi/4, pi/4], scaling in [0.95, 1.05] (the port's own copy of
``insmos_tpu/data/augment.py``). Every draw comes from the generator the
caller passes."""

from __future__ import annotations

import numpy as np

from .processor import rotate_points_z


def random_flip_x(points: np.ndarray, boxes: np.ndarray,
                  rng: np.random.Generator):
    """Flip about the x axis (negate y) with p=0.5; boxes flip y and heading."""
    if rng.random() < 0.5:
        points[:, 1] = -points[:, 1]
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
    return points, boxes


def random_rotation(points: np.ndarray, boxes: np.ndarray,
                    rng: np.random.Generator,
                    rot_range=(-np.pi / 4, np.pi / 4)):
    angle = rng.uniform(rot_range[0], rot_range[1])
    points[:, 0:3] = rotate_points_z(points[:, 0:3], angle)
    boxes[:, 0:3] = rotate_points_z(boxes[:, 0:3], angle)
    boxes[:, 6] += angle
    return points, boxes


def random_scaling(points: np.ndarray, boxes: np.ndarray,
                   rng: np.random.Generator, scale_range=(0.95, 1.05)):
    if scale_range[1] - scale_range[0] < 1e-3:
        return points, boxes
    s = rng.uniform(scale_range[0], scale_range[1])
    points[:, 0:3] *= s
    boxes[:, 0:6] *= s
    return points, boxes


def augment_window(points: np.ndarray, boxes7: np.ndarray,
                   rng: np.random.Generator):
    """flip(x) -> rotate(+-pi/4) -> scale(0.95-1.05), the reference order."""
    points, boxes7 = random_flip_x(points, boxes7, rng)
    points, boxes7 = random_rotation(points, boxes7, rng)
    points, boxes7 = random_scaling(points, boxes7, rng)
    return points, boxes7
