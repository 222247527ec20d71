"""Fixed-capacity padded window samples (the port's own copy of
``insmos_tpu/data/sample.py``). A sample is a set of capacity-padded
arrays with masks; the current scan occupies the last slot, and a warm-up
window of n < W scans the last n slots."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass
class WindowSample:
    """One sliding-window sample (host numpy, ready for device upload)."""

    points: np.ndarray  # (W, P, 4) float32 x,y,z,intensity, zero-padded
    num_points: np.ndarray  # (W,) int32 valid points per slot
    scan_mask: np.ndarray  # (W,) bool slot holds a real scan
    labels: np.ndarray  # (W, P) int32 learning-class labels (0 where absent/pad)
    gt_boxes: np.ndarray  # (M, 8) float32 [x,y,z,dx,dy,dz,yaw,class], zero pad
    num_boxes: np.ndarray  # () int32
    meta: Any = None  # (seq, scan_idx, past_indices) — host only

    @property
    def window(self) -> int:
        return self.points.shape[0]

    @property
    def capacity(self) -> int:
        return self.points.shape[1]

    def arrays(self) -> dict[str, np.ndarray]:
        return {
            "points": self.points,
            "num_points": self.num_points,
            "scan_mask": self.scan_mask,
            "labels": self.labels,
            "gt_boxes": self.gt_boxes,
            "num_boxes": self.num_boxes,
        }


def pad_points(
    pts: np.ndarray, capacity: int, labels: np.ndarray | None = None
) -> tuple[np.ndarray, int, np.ndarray]:
    """Pad/truncate an (N, C) point array to (capacity, C).

    Returns (padded_points, n_valid, padded_labels). Truncation keeps the
    first `capacity` points (scan row order), matching how a fixed buffer
    would fill; KITTI scans fit the default capacity.
    """
    n = min(pts.shape[0], capacity)
    out = np.zeros((capacity, pts.shape[1]), dtype=np.float32)
    out[:n] = pts[:n]
    lab = np.zeros((capacity,), dtype=np.int32)
    if labels is not None:
        lab[:n] = labels.reshape(-1)[: pts.shape[0]][:n]
    return out, n, lab


def make_window_sample(
    scans: list[np.ndarray],
    capacity: int,
    window: int,
    labels: list[np.ndarray] | None = None,
    gt_boxes: np.ndarray | None = None,
    max_boxes: int = 100,
    meta: Any = None,
) -> WindowSample:
    """Assemble scans (oldest..current) into a padded WindowSample."""
    n = len(scans)
    assert n <= window, f"{n} scans > window {window}"
    points = np.zeros((window, capacity, 4), dtype=np.float32)
    num_points = np.zeros((window,), dtype=np.int32)
    scan_mask = np.zeros((window,), dtype=bool)
    lab = np.zeros((window, capacity), dtype=np.int32)
    for i, pts in enumerate(scans):
        slot = window - n + i
        li = None if labels is None else labels[i]
        points[slot], num_points[slot], lab[slot] = pad_points(pts, capacity, li)
        scan_mask[slot] = True
    boxes = np.zeros((max_boxes, 8), dtype=np.float32)
    nb = 0
    if gt_boxes is not None and len(gt_boxes):
        nb = min(len(gt_boxes), max_boxes)
        boxes[:nb] = gt_boxes[:nb]
    return WindowSample(
        points=points,
        num_points=num_points,
        scan_mask=scan_mask,
        labels=lab,
        gt_boxes=boxes,
        num_boxes=np.int32(nb),
        meta=meta,
    )


def stack_samples(samples: list[WindowSample]) -> dict[str, np.ndarray]:
    """Stack samples into a batched dict of arrays (leading batch dim)."""
    keys = samples[0].arrays().keys()
    return {k: np.stack([s.arrays()[k] for s in samples]) for k in keys}


def to_device(batch: dict, device) -> dict:
    """numpy arrays -> tensors on ``device`` (the model's sample or batch
    dict)."""
    import torch

    return {k: torch.as_tensor(np.array(v)).to(device)
            for k, v in batch.items()}
