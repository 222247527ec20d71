"""Prediction visualizer (the port's own copy of
``insmos_tpu/cli/visualize.py``; reference visual/vis_mos_bbox.py).

Renders scans colored by predicted MOS class with predicted boxes overlaid.
Two backends, each imported only when it renders:
- open3d interactive viewer (n/b/q navigation) with ``--interactive``;
- matplotlib BEV snapshot PNGs otherwise.

Score gating matches the reference: cars at 0.5, pedestrians/cyclists at
0.2.

  python -m insmos_tpu_torch.cli.visualize --data_path <root> \
      --pred preb_out/<ID> --seq 8 --frames 0 5 --out vis/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.kitti import load_files, read_point_cloud
from ..ops.iou3d import boxes_to_corners_bev
from ..utils.io import read_pred_labels

SCORE_GATE = {1: 0.5, 2: 0.2, 3: 0.2}
CLS_COLOR = {0: (0.6, 0.6, 0.6), 1: (0.1, 0.4, 0.9), 2: (0.9, 0.15, 0.1)}


def gate_boxes(pred: dict) -> np.ndarray:
    boxes = np.asarray(pred["pred_boxes"]).reshape(-1, 7)
    scores = np.asarray(pred["pred_scores"]).reshape(-1)
    labels = np.asarray(pred["pred_labels"]).reshape(-1)
    keep = np.array(
        [s >= SCORE_GATE.get(int(l), 0.5) for s, l in zip(scores, labels)], bool
    )
    return boxes[keep], labels[keep]


def point_colors(scan, mos, boxes, labels, mode: str) -> np.ndarray:
    """Per-point RGB colors.

    mode "class":    MOS class colors (static blue / moving red).
    mode "instance": every box instance gets its own palette color; points
                     in no box keep the gray base; moving points outside
                     boxes stay class-red. Replicates the reference's
                     per-instance coloring path (visual/vis_mos_bbox.py:326,
                     Array_Index.find_point_in_instance_bbox_with_yaw with
                     ground offset 0.2 via the on-device op's numpy oracle)
                     but with distinct instance colors instead of uniform
                     cyan; mode "ref" reproduces the exact reference scheme
                     (gray base, cyan in-box, red moving).
    """
    n = len(scan)
    if mode == "class" or not len(boxes):
        if mode in ("instance", "ref"):
            base = np.full((n, 3), 0.5)
            base[mos == 2] = (1.0, 0.0, 0.0)
            return base
        return np.array([CLS_COLOR[int(c)] for c in mos])

    from ..ops.points_in_boxes import points_in_rotated_boxes_np

    lifted = boxes.copy()
    lifted[:, 2] += 0.2  # reference ground offset (vis_mos_bbox.py:326)
    inside = points_in_rotated_boxes_np(scan[:, :3], lifted)  # (N, M)
    # max box index tie-break — the documented deterministic replacement
    # for the reference's OpenMP last-writer race (ops/points_in_boxes.py)
    m = inside.shape[1]
    ids = np.where(inside.any(1), m - inside[:, ::-1].argmax(1), 0)
    hit = inside.any(1) & np.isin(labels, (1, 2))[ids - 1]

    base = np.full((n, 3), 0.5)
    if mode == "ref":
        base[hit] = (0.0, 1.0, 1.0)
        base[mos == 2] = (1.0, 0.0, 0.0)
        return base
    base[mos == 2] = (1.0, 0.0, 0.0)
    palette = np.array(
        [
            (0.0, 1.0, 1.0), (1.0, 0.6, 0.0), (0.2, 1.0, 0.2),
            (1.0, 0.2, 1.0), (1.0, 1.0, 0.2), (0.4, 0.6, 1.0),
            (0.0, 0.7, 0.4), (0.8, 0.4, 0.1),
        ]
    )
    base[hit] = palette[(ids[hit] - 1) % len(palette)]
    return base


def render_bev_png(scan, mos, boxes, labels, out_path, extent=60.0, color="class"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 9), dpi=110)
    colors = point_colors(scan, mos, boxes, labels, color)
    ax.scatter(scan[:, 0], scan[:, 1], s=0.3, c=colors, linewidths=0)
    if len(boxes):
        corners = boxes_to_corners_bev(
            torch.from_numpy(np.asarray(boxes, np.float32))).numpy()  # (M, 4, 2)
        for c in corners:
            poly = np.vstack([c, c[:1]])
            ax.plot(poly[:, 0], poly[:, 1], color="lime", linewidth=1.2)
    ax.set_xlim(-extent, extent)
    ax.set_ylim(-extent, extent)
    ax.set_aspect("equal")
    ax.set_title(os.path.basename(out_path))
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def run_open3d(scans, labels_per_scan, boxes_per_scan, color="class"):
    import open3d as o3d  # pragma: no cover - optional dependency

    idx = {"i": 0}

    def make_geoms(i):
        scan, mos, (boxes, blab) = scans[i], labels_per_scan[i], boxes_per_scan[i]
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(scan[:, :3])
        pcd.colors = o3d.utility.Vector3dVector(
            point_colors(scan, mos, boxes, blab, color)
        )
        geoms = [pcd]
        for b in boxes:
            obb = o3d.geometry.OrientedBoundingBox(
                b[0:3],
                o3d.geometry.get_rotation_matrix_from_xyz((0, 0, b[6])),
                b[3:6],
            )
            obb.color = (0, 1, 0)
            geoms.append(obb)
        return geoms

    vis = o3d.visualization.VisualizerWithKeyCallback()
    vis.create_window("InsMOS")
    for g in make_geoms(0):
        vis.add_geometry(g)

    def jump(d):
        def cb(v):
            idx["i"] = int(np.clip(idx["i"] + d, 0, len(scans) - 1))
            v.clear_geometries()
            for g in make_geoms(idx["i"]):
                v.add_geometry(g, reset_bounding_box=False)
            return True

        return cb

    vis.register_key_callback(ord("N"), jump(+1))
    vis.register_key_callback(ord("B"), jump(-1))
    vis.register_key_callback(ord("Q"), lambda v: (v.close(), False)[1])
    vis.run()


def main(argv=None):
    p = argparse.ArgumentParser(description="InsMOS visualizer")
    p.add_argument("--data_path", required=True)
    p.add_argument("--pred", required=True, help="preb_out/<ID> root")
    p.add_argument("--seq", type=int, default=8)
    p.add_argument("--frames", type=int, nargs="*", default=None)
    p.add_argument("--out", default="vis")
    p.add_argument("--interactive", action="store_true", help="open3d viewer")
    p.add_argument(
        "--color", choices=("class", "instance", "ref"), default="class",
        help="point coloring: MOS class, per-instance palette, or the "
        "reference's gray/cyan/red scheme (vis_mos_bbox.py:326-331)",
    )
    args = p.parse_args(argv)

    ss = f"{args.seq:02d}"
    sub = os.path.join("sequences", ss, "predictions")
    scan_paths = load_files(os.path.join(args.data_path, ss, "velodyne"))
    mos_paths = load_files(os.path.join(args.pred, "mos_preb", sub))
    bbox_paths = load_files(os.path.join(args.pred, "bbox_preb", sub))
    frames = args.frames or list(range(len(scan_paths)))

    if args.interactive:
        scans = [read_point_cloud(scan_paths[i]) for i in frames]
        labels = [read_pred_labels(mos_paths[i]) for i in frames]
        boxes = [
            gate_boxes(np.load(bbox_paths[i], allow_pickle=True).item())
            for i in frames
        ]
        run_open3d(scans, labels, boxes, color=args.color)
        return

    os.makedirs(args.out, exist_ok=True)
    for i in frames:
        scan = read_point_cloud(scan_paths[i])
        mos = read_pred_labels(mos_paths[i])
        boxes, labels = gate_boxes(np.load(bbox_paths[i], allow_pickle=True).item())
        render_bev_png(
            scan, mos, boxes, labels,
            os.path.join(args.out, f"{ss}_{i:06d}.png"), color=args.color,
        )
    print(f"wrote {len(frames)} PNGs to {args.out}")


if __name__ == "__main__":
    main()
