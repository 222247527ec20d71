"""MOS IoU evaluator (the port's own copy of
``insmos_tpu/cli/evaluate_mos.py``).

The reference delegates accuracy evaluation to the external
semantic-kitti-api `evaluate_mos.py` over written .label files. This
equivalent computes the same confusion-matrix IoU (moving class is the
headline number) over predict_mos's artifact tree.

  python -m insmos_tpu_torch.cli.evaluate_mos --data_path <root> \
      --pred preb_out/<ID>/mos_preb [--sequences 8]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..constants import N_MOS_CLASSES, map_semantic_labels
from ..data.kitti import load_files


def evaluate(
    data_path: str, pred_root: str, sequences: list[int]
) -> dict[str, float]:
    cm = np.zeros((N_MOS_CLASSES, N_MOS_CLASSES), np.int64)
    for seq in sequences:
        ss = f"{int(seq):02d}"
        gt_files = load_files(os.path.join(data_path, ss, "labels"))
        pred_files = load_files(
            os.path.join(pred_root, "sequences", ss, "predictions")
        )
        assert len(gt_files) == len(pred_files), (
            f"seq {ss}: {len(gt_files)} gt vs {len(pred_files)} pred files"
        )
        for gf, pf in zip(gt_files, pred_files):
            gt = map_semantic_labels(np.fromfile(gf, dtype=np.uint32))
            pred = map_semantic_labels(np.fromfile(pf, dtype=np.uint32))
            assert len(gt) == len(pred), f"{pf}: {len(pred)} vs {len(gt)} points"
            flat = pred.astype(np.int64) * N_MOS_CLASSES + gt
            cm += np.bincount(flat, minlength=9).reshape(3, 3)

    # semantic-kitti-api MOS protocol: ignore class 0 (both axes)
    full = cm.astype(np.float64)
    full[:, 0] = 0
    full[0, :] = 0
    tp = np.diag(full)
    fp = full.sum(1) - tp
    fn = full.sum(0) - tp
    iou = tp / np.maximum(tp + fp + fn, 1e-15)
    return {
        "iou_static": float(iou[1]),
        "iou_moving": float(iou[2]),
        "acc": float(tp.sum() / max(full.sum(), 1e-15)),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="MOS IoU evaluation")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--pred", type=str, required=True, help=".../mos_preb root")
    p.add_argument("--sequences", type=int, nargs="*", default=[8])
    args = p.parse_args(argv)
    res = evaluate(args.data_path, args.pred, args.sequences)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
