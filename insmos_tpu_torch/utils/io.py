"""Prediction artifact IO (the port's own copy of ``insmos_tpu/utils/io.py``),
byte-identical to the reference layout.

predict_mos writes, per scan XXXXXX of sequence SS:
  preb_out/<ID>/mos_preb/sequences/SS/predictions/XXXXXX.label
      int32 little-endian, values in {0, 9, 251}
  preb_out/<ID>/confidence/sequences/SS/predictions/XXXXXX.npy
      float (N, 2) = softmax(logits with ignored col at -inf)[:, 1:]
  preb_out/<ID>/bbox_preb/sequences/SS/predictions/XXXXXX.npy
      pickled dict {pred_boxes (K, 7), pred_scores (K,), pred_labels (K,)}

refine writes preb_out_refine/mos_preb/sequences/SS/predictions/*.label.
"""

from __future__ import annotations

import os

import numpy as np

from ..constants import to_original_labels


def artifact_dirs(out_root: str, experiment_id: str, seq: int) -> dict[str, str]:
    ss = f"{int(seq):02d}"
    base = os.path.join(out_root, experiment_id)
    dirs = {
        "mos": os.path.join(base, "mos_preb", "sequences", ss, "predictions"),
        "confidence": os.path.join(base, "confidence", "sequences", ss, "predictions"),
        "bbox": os.path.join(base, "bbox_preb", "sequences", ss, "predictions"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def softmax_ignore(logits: np.ndarray, ignore_index=(0,)) -> np.ndarray:
    """softmax with ignored-class logits at -inf."""
    x = logits.astype(np.float64).copy()
    x[:, list(ignore_index)] = -np.inf
    x -= x.max(axis=1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


def write_scan_artifacts(
    dirs: dict[str, str],
    scan_idx: int,
    point_logits: np.ndarray,  # (N, 3) raw logits, N = raw scan size
    boxes: np.ndarray,  # (K, 7) world boxes
    scores: np.ndarray,  # (K,)
    labels: np.ndarray,  # (K,) 1-indexed classes
) -> None:
    name = f"{scan_idx:06d}"
    softmax = softmax_ignore(point_logits)
    np.save(
        os.path.join(dirs["confidence"], name + ".npy"),
        softmax[:, 1:].astype(np.float64),
    )
    pred = np.argmax(softmax, axis=1)
    to_original_labels(pred).astype(np.int32).tofile(
        os.path.join(dirs["mos"], name + ".label")
    )
    np.save(
        os.path.join(dirs["bbox"], name + ".npy"),
        {
            "pred_boxes": boxes.astype(np.float32),
            "pred_scores": scores.astype(np.float32),
            "pred_labels": labels.astype(np.int64),
        },
    )


def read_pred_labels(path: str) -> np.ndarray:
    """Read a predicted .label file back to learning classes {0,1,2}."""
    raw = np.fromfile(path, dtype=np.uint32) & 0xFFFF
    out = np.zeros_like(raw, dtype=np.int32)
    out[raw == 9] = 1
    out[raw == 251] = 2
    return out
