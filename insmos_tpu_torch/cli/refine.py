"""Refinement CLI (the port's own copy of ``insmos_tpu/cli/refine.py``):
temporal voting over predicted instances, with the reference's rules and
artifact layout.

Reads predict_mos artifacts + raw scans + poses, re-assigns car points by
per-instance moving ratios, scene-level moving-car counts, and a 5-frame
pose-aligned instance track, then rewrites labels under
preb_out_refine/mos_preb. The per-point box test is the port's numpy
points-in-box op; the per-instance voting is segment arithmetic. Host-side
numpy throughout.

  python -m insmos_tpu_torch.cli.refine --data_path <root> --split valid \
      [--pred preb_out/<ID>] [--out preb_out_refine]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..constants import to_original_labels
from ..data.kitti import lidar_poses_from_files, load_files, read_point_cloud
from ..ops.points_in_boxes import points_in_rotated_boxes_np
from ..utils.io import read_pred_labels

VALID_SEQS = [8]
TEST_SEQS = [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]

INSTANCE_WINDOW = 5
GROUND_OFFSET = 0.03
MOVING_RATIO = 0.6
COUNT_RATIO = 0.3
CANDIDATE_RATIO = 0.001
CONFIDENCE_FRAC = 0.5
CONFIDENCE_EPS = 1e-5


def car_instance_ids(scan: np.ndarray, boxes: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """(N,) 1-indexed id of the car box containing each point (0 = none).

    Box centers lifted by GROUND_OFFSET (Array_Index.cpp:106); overlapping
    boxes resolve to the max index (deterministic tie-break, see
    ops.points_in_boxes).
    """
    if len(boxes) == 0:
        return np.zeros(len(scan), np.int32)
    lifted = boxes.copy()
    lifted[:, 2] += GROUND_OFFSET
    inside = points_in_rotated_boxes_np(scan[:, :3], lifted)  # (N, M)
    inside &= (labels == 1)[None, :]
    ids = np.where(inside, np.arange(1, len(boxes) + 1)[None, :], 0)
    return ids.max(axis=1).astype(np.int32)


def frame_instance_stats(boxes, labels, ids, mos, conf):
    """Vectorized per-instance stats (reference refine.py:210-240).

    Returns (car_box_idx (C,) 0-based box indices of kept cars in box
    order, point lists implied by ids, ratio (C,), conf_frac (C,),
    attrs (C, 7)).
    """
    M = len(boxes)
    if M == 0:
        z = np.zeros((0,))
        return np.zeros((0,), np.int64), z, z, np.zeros((0, 7))
    cnt = np.bincount(ids, minlength=M + 1)[1:]  # points per box (1-indexed ids)
    mov = np.bincount(ids, weights=(mos == 2).astype(np.float64), minlength=M + 1)[1:]
    cf = np.bincount(
        ids, weights=(conf[:, 1] >= CONFIDENCE_EPS).astype(np.float64),
        minlength=M + 1,
    )[1:]
    keep = (labels == 1) & (cnt > 0)
    car_box_idx = np.flatnonzero(keep)
    ratio = mov[car_box_idx] / cnt[car_box_idx]
    conf_frac = cf[car_box_idx] / cnt[car_box_idx]
    attrs = np.concatenate(
        [boxes[car_box_idx, 0:6], (ratio > MOVING_RATIO)[:, None].astype(np.float64)],
        axis=1,
    )
    return car_box_idx, ratio, conf_frac, attrs


def track_instances(attrs, attr_window, poses, frame_idx, moving_car_num):
    """Vectorized 5-frame pose-aligned instance track (refine.py:262-296).

    Mutates attrs[:, -1] (moving flag) in place. attr_window holds the 5
    previous frames' attrs ((P_i, 7) arrays), oldest first.
    """
    C = len(attrs)
    if C == 0:
        return
    found = np.zeros(C, np.int64)
    moving = np.zeros(C, np.int64)
    for i in range(INSTANCE_WINDOW):
        tf = np.linalg.inv(poses[frame_idx - i - 1]) @ poses[frame_idx]
        ctr = attrs[:, 0:3] @ tf[:3, :3].T + tf[:3, 3]  # (C, 3)
        prev = attr_window[INSTANCE_WINDOW - 1 - i]  # (P, 7)
        if len(prev) == 0:
            continue
        d_ctr = np.abs(ctr[:, None, :] - prev[None, :, 0:3])  # (C, P, 3)
        d_dim = np.abs(attrs[:, None, 3:6] - prev[None, :, 3:6])
        match = (
            (d_ctr[..., 0] < 1) & (d_ctr[..., 1] < 1) & (d_ctr[..., 2] < 0.5)
            & (d_dim < 0.3).all(-1)
        )  # (C, P)
        hit = match.any(axis=1)
        first = np.argmax(match, axis=1)  # first match (the loop's `break`)
        found += hit
        moving += hit & (prev[first, -1] == 1)
    full = found == INSTANCE_WINDOW
    flag = (full & (moving > 3)) | (
        ~full & ((moving > 1) | ((moving > 0) & (moving_car_num >= 3)))
    )
    attrs[flag, -1] = 1


def refine_frame(mos, ids, boxes, labels, conf, frame_idx, attr_window, poses):
    """One frame of the voting pass, fully vectorized. Mutates mos;
    returns this frame's attrs (appended to the caller's window)."""
    car_box_idx, ratio, conf_frac, attrs = frame_instance_stats(
        boxes, labels, ids, mos, conf
    )
    moving_car_num = int((ratio > COUNT_RATIO).sum())
    candidates = ratio > CANDIDATE_RATIO
    conf_candidates = conf_frac > CONFIDENCE_FRAC

    def set_points(car_mask, value):
        if not car_mask.any():
            return
        sel = np.isin(ids, car_box_idx[car_mask] + 1)
        mos[sel] = value

    # ---- scene-level rules (refine.py:242-259) ----
    if frame_idx != 0:
        if moving_car_num >= 3:
            if frame_idx < INSTANCE_WINDOW:
                set_points(candidates, 2)
            attrs[candidates, -1] = 1
        if moving_car_num >= 5:
            if frame_idx < INSTANCE_WINDOW:
                set_points(conf_candidates, 2)
            attrs[conf_candidates, -1] = 1
    elif moving_car_num >= 5:
        set_points(candidates, 2)
        set_points(conf_candidates, 2)

    # ---- 5-frame instance track + top-down rewrite (refine.py:262-296) ----
    if frame_idx >= INSTANCE_WINDOW:
        track_instances(attrs, attr_window, poses, frame_idx, moving_car_num)
        flagged = attrs[:, -1] == 1
        set_points(flagged, 2)
        if len(attrs) > 6:
            set_points(~flagged, 1)
    return attrs


def refine_sequence(seq_dir: str, pred_dir: str, out_dir: str, ss: str,
                    n_past_steps: int = 10) -> None:
    sub = os.path.join("sequences", ss, "predictions")
    scan_paths = load_files(os.path.join(seq_dir, "velodyne"))
    bbox_paths = load_files(os.path.join(pred_dir, "bbox_preb", sub))
    mos_paths = load_files(os.path.join(pred_dir, "mos_preb", sub))
    conf_paths = load_files(os.path.join(pred_dir, "confidence", sub))
    assert len(scan_paths) == len(bbox_paths) == len(mos_paths) == len(conf_paths)
    poses = lidar_poses_from_files(
        os.path.join(seq_dir, "poses.txt"), os.path.join(seq_dir, "calib.txt")
    )
    os.makedirs(out_dir, exist_ok=True)

    # attrs per tracked frame: (C, 7) arrays [cx, cy, cz, dx, dy, dz, flag]
    attr_window: list[np.ndarray] = []

    for frame_idx in range(len(scan_paths)):
        scan = read_point_cloud(scan_paths[frame_idx])
        pred = np.load(bbox_paths[frame_idx], allow_pickle=True).item()
        boxes = np.asarray(pred["pred_boxes"], np.float64).reshape(-1, 7)
        labels = np.asarray(pred["pred_labels"]).reshape(-1)
        mos = read_pred_labels(mos_paths[frame_idx]).astype(np.int32)
        conf = np.load(conf_paths[frame_idx]).reshape(-1, 2)
        if frame_idx < n_past_steps - 1:
            # warm-up scans (growing window) have no usable confidence
            conf = np.zeros((len(mos), 2))

        ids = car_instance_ids(scan, boxes, labels)
        attrs = refine_frame(
            mos, ids, boxes, labels, conf, frame_idx, attr_window, poses
        )
        attr_window.append(attrs)
        if len(attr_window) > INSTANCE_WINDOW:
            attr_window.pop(0)

        name = os.path.basename(mos_paths[frame_idx])[:6]
        to_original_labels(mos).astype(np.int32).tofile(
            os.path.join(out_dir, name + ".label")
        )


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="InsMOS refinement")
    p.add_argument("--data_path", type=str, default="demo_data")
    p.add_argument("--split", type=str, default="valid")
    p.add_argument("--pred", type=str, default="preb_out/InsMOS",
                   help="predict_mos output root incl. experiment id")
    p.add_argument("--out", type=str, default="preb_out_refine")
    p.add_argument("--sequences", type=int, nargs="*", default=None)
    p.add_argument("--cfg_file", type=str, default=None,
                   help="config yaml; sets the warm-up window (n_past_steps)")
    p.add_argument("--n_past_steps", type=int, default=None,
                   help="window size override (default: cfg or 10)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    n_past = args.n_past_steps
    if n_past is None and args.cfg_file:
        from ..config import Config

        n_past = Config.from_yaml(args.cfg_file).model.n_past_steps
    if n_past is None:
        n_past = 10
    seqs = args.sequences or (VALID_SEQS if args.split == "valid" else TEST_SEQS)
    for seq in seqs:
        ss = f"{int(seq):02d}"
        refine_sequence(
            os.path.join(args.data_path, ss),
            args.pred,
            os.path.join(args.out, "mos_preb", "sequences", ss, "predictions"),
            ss,
            n_past_steps=n_past,
        )


if __name__ == "__main__":
    main()
