"""Shared inputs of the training parity tests (tests/test_torch_train*.py
and tests/torch_train_record.py): a window of the HDL-64E raycast fixture
with labels and boxes, and numpy weights whose heatmap scores spread.

With ``init_params`` weights the detection head's scores lie within ~1e-7
of each other, so the boxes that greedy NMS keeps depend on summation
order, and through the box fusion so do the MOS loss and the UNet
gradients. tools.train_record.record_params scales the class heatmap's
1x1 conv by its SPREAD, which spreads the scores; the tests check that
both packages keep the same boxes before they trust a gradient
tolerance."""

from __future__ import annotations

import numpy as np

BOXES = np.array([[3.0, 1.0, -0.8, 4.5, 1.9, 1.6, 0.3, 1],
                  [-2.0, -3.0, -0.9, 0.8, 0.8, 1.7, 0.0, 2]], np.float32)


def train_window(cfg, scans, seed: int = 0, boxes=BOXES) -> dict:
    """The sample dict of one training window: ``scans`` (oldest first,
    the last the current scan) padded into the config's slots, labels drawn
    from default_rng(seed) (1 static or 2 moving, 0 for a few unlabelled
    points) and ``boxes``."""
    rng = np.random.default_rng(seed)
    W, P = cfg.model.n_past_steps, cfg.runtime.max_points_per_scan
    pts = np.zeros((W, P, 4), np.float32)
    num = np.zeros(W, np.int32)
    mask = np.zeros(W, bool)
    for i, s in enumerate(scans[-W:]):
        slot = W - len(scans[-W:]) + i
        n = min(len(s), P)
        pts[slot, :n] = s[:n]
        num[slot] = n
        mask[slot] = True
    labels = rng.choice(np.int32([0, 1, 2]), size=(W, P), p=[0.05, 0.6, 0.35])
    gt = np.zeros((cfg.model.head.max_objs, 8), np.float32)
    gt[:len(boxes)] = boxes
    return dict(points=pts, num_points=num, scan_mask=mask,
                labels=labels.astype(np.int32), gt_boxes=gt,
                num_boxes=np.int32(len(boxes)))


def tree_items(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def close(got, ref, tol, what):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max() if ref.size else 0.0), (
        what, err)


def stack(samples):
    """Sample dicts -> one batch dict (leading batch axis)."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
